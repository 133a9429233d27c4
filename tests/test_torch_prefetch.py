"""The port's host -> device prefetcher (graphical_gan_tpu_torch/data/
prefetch.py) on the CPU: batches arrive in order as tensors (arrays,
tuples and dicts of arrays), an exception in the iterator reaches the
consumer after the batches before it, closing the generator early releases
the worker thread and stops pulling from the iterator, and the CPU copy
counts no side-stream batch. A stress run of many prefetchers with a short
switch interval keeps every stream's order."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from graphical_gan_tpu_torch.data import prefetch
from graphical_gan_tpu_torch.data.prefetch import prefetch_to_device


def _wait_until(cond, timeout=10.0):
    t0 = time.time()
    while not cond() and time.time() - t0 < timeout:
        time.sleep(0.01)
    return cond()


@pytest.mark.parametrize("size", [1, 2, 5])
def test_batches_arrive_in_order(size):
    src = [np.full((2, 3), i, np.int32) for i in range(7)]
    got = list(prefetch_to_device(iter(src), size=size, device="cpu"))
    assert len(got) == 7
    for i, t in enumerate(got):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.int32
        assert torch.equal(t, torch.from_numpy(src[i]))


def test_tuples_and_dicts_are_copied_leaf_by_leaf():
    items = [(np.arange(3) + i, {"x": np.ones(2) * i})
             for i in range(3)]
    items = [{"a": a, "b": b["x"]} for a, b in items] + [
        (np.zeros(2), np.ones(2))]
    got = list(prefetch_to_device(iter(items), device="cpu"))
    for i, d in enumerate(got[:3]):
        assert set(d) == {"a", "b"}
        assert torch.equal(d["a"], torch.arange(3) + i)
    assert isinstance(got[3], tuple) and torch.equal(got[3][1],
                                                     torch.ones(2,
                                                                dtype=torch.float64))


def test_an_exception_reaches_the_consumer_after_the_batches_before_it():
    def src():
        yield np.zeros(2)
        yield np.ones(2)
        raise RuntimeError("loader broke")

    g = prefetch_to_device(src(), device="cpu")
    assert float(next(g).sum()) == 0.0
    assert float(next(g).sum()) == 2.0
    with pytest.raises(RuntimeError, match="loader broke"):
        next(g)


def test_closing_early_releases_the_worker():
    pulled = []

    def endless():
        i = 0
        while True:
            pulled.append(i)
            yield np.array([i])
            i += 1

    before = threading.active_count()
    g = prefetch_to_device(endless(), size=2, device="cpu")
    assert int(next(g)) == 0 and int(next(g)) == 1
    g.close()
    assert _wait_until(lambda: threading.active_count() <= before)
    n = len(pulled)
    time.sleep(0.3)
    assert len(pulled) == n <= 2 + 2 + 1  # consumed + queued + in hand


def test_the_cpu_copy_counts_no_side_stream_batch():
    prefetch.side_stream_batches = 0
    list(prefetch_to_device(iter([np.zeros(1)] * 4), device="cpu"))
    assert prefetch.side_stream_batches == 0


def test_an_exhausted_iterator_ends_the_stream_and_the_worker():
    before = threading.active_count()
    assert list(prefetch_to_device(iter([]), device="cpu")) == []
    assert _wait_until(lambda: threading.active_count() <= before)


def test_many_prefetchers_keep_their_order_under_a_short_switch_interval():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    errors = []

    def consume(k):
        src = (np.array([k, i]) for i in range(200))
        got = [tuple(t.tolist()) for t in
               prefetch_to_device(src, size=1, device="cpu")]
        if got != [(k, i) for i in range(200)]:
            errors.append(k)

    try:
        threads = [threading.Thread(target=consume, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
