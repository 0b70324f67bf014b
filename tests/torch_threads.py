"""One intra-op torch thread for the port's CPU tests.

A test module of the port imports `one_torch_thread` (an autouse fixture),
so that each of its tests runs on one torch thread, and its module's
previous setting comes back when the module's tests end. Under
pytest-xdist the workers share the machine's cores, and torch's default
of a thread a core oversubscribes them: OpenMP's spinning threads made a
one-second recipe run in a worker take a minute. The port's CPU tests run
tiny shapes. The setting belongs to each module that imports the fixture,
so a test's threading does not depend on which other files a run collects.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
