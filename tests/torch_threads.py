"""One intra-op torch thread, and one MKL code path, for the port's CPU tests.

A test module of the port imports `one_torch_thread` (an autouse fixture),
so that each of its tests runs on one torch thread, and its module's
previous setting comes back when the module's tests end. Under
pytest-xdist the workers share the machine's cores, and torch's default
of a thread a core oversubscribes them: OpenMP's spinning threads made a
one-second recipe run in a worker take a minute. The port's CPU tests run
tiny shapes. The setting belongs to each module that imports the fixture,
so a test's threading does not depend on which other files a run collects.

Importing this module also pins MKL, which computes torch's CPU matmuls,
to its reproducible code path (`MKL_CBWR=COMPATIBLE`), for this process
and for every process a test spawns from it (the gloo workers inherit the
environment). MKL picks its sgemm kernels by the host's instruction set:
on an AVX2 or AVX-512 host the port's f32 gradients of the distributed
tests' fixture put one ReLU input of the FFN on the other side of 0 from
tpukit's (fault C9: `ffn/down/bias` off by 4.6e-5, a row of the position
embeddings by 2.8e-6), on an SSE host they do not. On the compatible path
the port's gradients are the same bits on every x86 host and agree with
tpukit's within GRAD_TOL. MKL reads the variable at its first call, which
no test makes before the modules are collected.
"""

import os

import pytest
import torch

os.environ["MKL_CBWR"] = "COMPATIBLE"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
