"""The port's host prefetcher against tpukit's contract
(tests/test_prefetch.py:39-130): order and values, depth only changing
timing, worker errors delivered where the failed item would have been,
the epoch flush and closing mid-epoch; then `fit` with the thread and
without it, bit for bit, and the loader's retried fetch.
"""

import itertools
import os
import time

import numpy as np
import pytest

from tpukit.prefetch import HostPrefetcher as TkHostPrefetcher
from tpukit_torch import chaos
from tpukit_torch import retry
from tpukit_torch.data import ArrayDataset
from tpukit_torch.loader import DataLoader
from tpukit_torch.prefetch import HostPrefetcher
from tpukit_torch.recipes import single
from tpukit_torch.shardings import leaves
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetcher_preserves_order_and_values(depth):
    items = [{"i": i} for i in range(17)]
    out = list(HostPrefetcher(items, lambda r: r["i"] * 3, depth=depth))
    assert out == [i * 3 for i in range(17)]
    assert out == list(TkHostPrefetcher(items, lambda r: r["i"] * 3, depth=depth))


def test_prefetcher_depth_equivalence_and_skip():
    items = list(range(23))
    assert list(HostPrefetcher(items, depth=1)) == list(HostPrefetcher(items, depth=4)) == items
    assert list(HostPrefetcher(items, depth=2, skip=5)) == items[5:]
    assert list(HostPrefetcher(items, depth=2, skip=30)) == []
    with pytest.raises(ValueError, match="skip"):
        HostPrefetcher(items, skip=-1)


def test_prefetcher_propagates_worker_exception_in_iterable():
    def gen():
        yield 1
        yield 2
        raise ValueError("loader blew up")

    pf = HostPrefetcher(gen(), depth=2)
    got = []
    with pytest.raises(ValueError, match="loader blew up"):
        for x in pf:
            got.append(x)
    assert got == [1, 2]  # the good items before the failure, in order
    assert not pf._thread.is_alive()


def test_prefetcher_propagates_worker_exception_in_process_fn():
    def boom(x):
        if x == 3:
            raise RuntimeError("prepare failed")
        return x

    got = []
    with pytest.raises(RuntimeError, match="prepare failed"):
        for x in HostPrefetcher(range(10), boom, depth=4):
            got.append(x)
    assert got == [0, 1, 2]


def test_prefetcher_epoch_boundary_flush():
    """One prefetcher an epoch: each yields exactly its epoch's batches (the
    port's loader, reshuffled by `set_epoch`), nothing buffered across."""
    ids = np.arange(64 * 4, dtype=np.int32).reshape(64, 4)
    loader = DataLoader(ArrayDataset(ids, np.ones_like(ids)), 8, shuffle=True)

    def epoch_rows(epoch):
        loader.set_epoch(epoch)
        pf = HostPrefetcher(loader, depth=2)
        batches = list(pf)
        assert not pf._thread.is_alive()
        return [tuple(b["input_ids"][:, 0]) for b in batches]

    e0, e1 = epoch_rows(0), epoch_rows(1)
    assert len(e0) == len(e1) == 8 and e0 != e1
    assert epoch_rows(0) == e0


def test_prefetcher_close_mid_epoch_releases_worker():
    pf = HostPrefetcher(itertools.count(), depth=2)
    assert next(pf) == 0
    pf.close()
    assert not pf._thread.is_alive()
    assert list(pf) == []
    pf.close()  # idempotent


def test_prefetcher_rejects_bad_depth():
    with pytest.raises(ValueError, match="depth"):
        HostPrefetcher([], depth=0)


def test_prefetcher_window_stats_and_quiesce():
    pf = HostPrefetcher(list(range(6)), depth=2)
    with pf.quiesce():  # the worker holds between items; the buffer serves
        first = next(pf)
    assert [first] + list(pf) == list(range(6))
    assert 0.0 <= pf.window_stats()["occupancy"] <= 2.0
    assert pf.window_stats()["occupancy"] == 0.0


def test_prefetcher_occupancy_excludes_done_sentinel():
    pf = HostPrefetcher([42], depth=2)
    time.sleep(0.2)  # the worker has queued the item and the end
    assert list(pf) == [42]
    assert pf.window_stats()["occupancy"] == 0.0


def test_loader_fetch_is_retried_under_injected_faults():
    """`loader_io_fail@2:2` fails the second batch's fetch twice; the retry
    wrapper absorbs it and the batches are the clean ones."""
    ids = np.arange(40 * 4, dtype=np.int32).reshape(40, 4)
    loader = DataLoader(ArrayDataset(ids, np.ones_like(ids)), 8, shuffle=True)
    clean = [b["input_ids"] for b in loader]
    prev = chaos.install(chaos.ChaosEngine("loader_io_fail@2:2"))
    log = retry.RetryLog()
    retry.set_observer(log)
    try:
        faulty = [b["input_ids"] for b in HostPrefetcher(loader, depth=2)]
    finally:
        retry.set_observer(None)
        chaos.install(prev)
    assert all(np.array_equal(a, b) for a, b in zip(faulty, clean)) and len(faulty) == 5
    assert [e["label"] for e in log.drain()] == ["loader_fetch", "loader_fetch"]


ARGS = ["--batch_size", "8", "--epochs", "2", "--sequence_length", "64", "--dim", "32",
        "--head_dim", "8", "--heads", "4", "--num_layers", "2", "--learning_rate", "1e-3",
        "--dataset_slice", "80", "--num_workers", "0", "--disable_amp", "--device", "cpu"]


def test_fit_prefetch_is_bit_identical_to_the_synchronous_path(tmp_path):
    """`--prefetch 3` against `--prefetch 0` over two epochs: the same
    windows, eval metrics, tokens and final parameters, bit for bit."""
    runs = {}
    cwd = os.getcwd()
    for depth in ("0", "3"):
        (tmp_path / depth).mkdir()
        os.chdir(tmp_path / depth)
        try:
            runs[depth] = single.main(ARGS + ["--prefetch", depth])
        finally:
            os.chdir(cwd)
    a, b = runs["0"], runs["3"]
    assert len(a.metrics["train_windows"]) == 2
    for key in ("train_windows", "eval", "train_tokens", "samples"):
        assert a.metrics[key] == b.metrics[key], key
    for x, y in zip(leaves(a.state.params), leaves(b.state.params)):
        assert x.equal(y)
