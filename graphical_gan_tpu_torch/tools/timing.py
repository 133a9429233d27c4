"""Device time of one call on the card, from CUDA events, with its inputs
read from device memory: the timer of ``chip_smoke.py`` and
``tools/bench_conv_kernel.py``.

The calls rotate over the argument sets a caller gives (or one) and copies
of them that together hold at least twice the card's L2 cache, so each
call reads its inputs from device memory, as a bytes bound assumes, and not
from what the call before left in L2. A spin kernel queued before each
timed run keeps the card busy while the host enqueues the calls, so host
overhead is not timed.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Optional, Sequence

import torch

L2_FALLBACK = 50 * 2 ** 20  # the H100's L2, where the properties lack it


def rotation_copies(nbytes: int, l2_bytes: int) -> int:
    """How many sets of arguments of ``nbytes`` in all the timer rotates
    over: at least two, and enough to hold twice ``l2_bytes`` (two when
    the arguments hold no tensor)."""
    if nbytes <= 0:
        return 2
    return max(2, -(-2 * l2_bytes // int(nbytes)))


def _clone(args: Sequence) -> tuple:
    return tuple(a.clone() if isinstance(a, torch.Tensor) else a
                 for a in args)


def time_ms(fn: Callable, args: Sequence, reps: int = 7,
            inner: int = 20, sets: Optional[Sequence[Sequence]] = None
            ) -> float:
    """Median device ms of one ``fn(*args)``, from CUDA events around
    ``inner`` back-to-back calls, over ``reps`` runs. ``sets``, where
    given, are the argument sets the calls rotate over in place of
    ``args`` (copies of them are added up to :func:`rotation_copies`).
    Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_ms measures on the card; CUDA is not "
                           "available")
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 L2_FALLBACK)
    given = [tuple(s) for s in sets] if sets else [tuple(args)]
    nbytes = sum(a.numel() * a.element_size() for a in given[0]
                 if isinstance(a, torch.Tensor))
    n = max(len(given), rotation_copies(nbytes, l2))
    sets = given + [_clone(given[i % len(given)])
                    for i in range(len(given), n)]
    calls = 0

    def run(k):
        nonlocal calls
        for _ in range(k):
            fn(*sets[calls % n])
            calls += 1

    run(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(inner)
    t_host = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(min(max(t_host * 2.0e9 * 1.5, 1e5), 4e9))
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        run(inner)
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return statistics.median(out)


def host_ms(fn: Callable, sets: Sequence[Sequence], reps: int = 7,
            inner: int = 20) -> float:
    """Median host-clock ms of one call of ``fn``, over ``reps`` runs of
    ``inner`` calls that rotate over the argument ``sets``: the CPU's
    counterpart of :func:`time_ms`, which names no device time."""
    sets = [tuple(s) for s in sets]
    fn(*sets[0])
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for i in range(inner):
            fn(*sets[i % len(sets)])
        out.append((time.perf_counter() - t0) * 1e3 / inner)
    return statistics.median(out)
