"""Scalar-metric logging (``graphical_gan_tpu/report/plot.py``): per-
iteration ``plot(name, value)`` buffers, ``tick()`` advances the step, and
``flush`` prints the means of the window since the last flush as
``iter N\\tname\\tvalue...`` and appends that line to ``logfile.txt``.
Curve images come with the report tools."""

from __future__ import annotations

import collections
from typing import Dict, Optional

import numpy as np


class MetricLogger:
    def __init__(self):
        self._since_last_flush: Dict[str, Dict[int, float]] = \
            collections.defaultdict(dict)
        self._iter = 0

    def tick(self) -> None:
        self._iter += 1

    def restore(self, iteration: int) -> None:
        """Fast-forward the tick counter (trainer resume)."""
        self._iter = int(iteration)

    @property
    def pending(self) -> bool:
        return bool(self._since_last_flush)

    def plot(self, name: str, value) -> None:
        self._since_last_flush[name][self._iter] = float(value)

    def plot_at(self, name: str, value, iteration: int) -> None:
        """Backfill a value at an earlier tick (device scalars are drained
        at flush boundaries, not every iteration)."""
        self._since_last_flush[name][int(iteration)] = float(value)

    def flush(self, logfile: Optional[str] = None) -> str:
        prints = ["{}\t{}".format(name, np.mean(list(vals.values())))
                  for name, vals in self._since_last_flush.items()]
        line = "iter {}\t{}".format(self._iter, "\t".join(prints))
        print(line)
        if logfile is not None:
            with open(logfile, "a") as f:
                f.write(line + "\n")
        self._since_last_flush.clear()
        return line
