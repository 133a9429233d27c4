"""Scalar-metric logging (``graphical_gan_tpu/report/plot.py``): per-
iteration ``plot(name, value)`` buffers, ``tick()`` advances the step, and
``flush(outf, logfile)`` prints the means of the window since the last
flush as ``iter N\\tname\\tvalue...``, appends that line to
``logfile.txt`` and re-renders one curve image per metric,
``<outf>/<name>.jpg`` over every value since the beginning
(``tflib/plot.py:22-41``). matplotlib is optional: where it cannot be
imported, nothing is rendered."""

from __future__ import annotations

import collections
import os
from typing import Dict, Optional

import numpy as np


class MetricLogger:
    def __init__(self):
        self._since_beginning: Dict[str, Dict[int, float]] = \
            collections.defaultdict(dict)
        self._since_last_flush: Dict[str, Dict[int, float]] = \
            collections.defaultdict(dict)
        self._iter = 0

    def tick(self) -> None:
        self._iter += 1

    def restore(self, iteration: int) -> None:
        """Fast-forward the tick counter (trainer resume)."""
        self._iter = int(iteration)

    @property
    def iteration(self) -> int:
        return self._iter

    @property
    def pending(self) -> bool:
        return bool(self._since_last_flush)

    def plot(self, name: str, value) -> None:
        self._since_last_flush[name][self._iter] = float(value)

    def plot_at(self, name: str, value, iteration: int) -> None:
        """Backfill a value at an earlier tick (device scalars are drained
        at flush boundaries, not every iteration)."""
        self._since_last_flush[name][int(iteration)] = float(value)

    def flush(self, outf: Optional[str] = None,
              logfile: Optional[str] = None, render: bool = True) -> str:
        prints = []
        for name, vals in self._since_last_flush.items():
            prints.append("{}\t{}".format(
                name, np.mean(list(vals.values()))))
            self._since_beginning[name].update(vals)
            if render and outf is not None:
                self._render(name, outf)
        line = "iter {}\t{}".format(self._iter, "\t".join(prints))
        print(line)
        if logfile is not None:
            with open(logfile, "a") as f:
                f.write(line + "\n")
        self._since_last_flush.clear()
        return line

    def _render(self, name: str, outf: str) -> None:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        xs = np.sort(list(self._since_beginning[name].keys()))
        ys = [self._since_beginning[name][x] for x in xs]
        plt.clf()
        plt.plot(xs, ys)
        plt.xlabel("iteration")
        plt.ylabel(name)
        plt.savefig(os.path.join(outf, name.replace(" ", "_") + ".jpg"))

    def history(self, name: str) -> Dict[int, float]:
        """Every flushed value of ``name``, by iteration."""
        return dict(self._since_beginning[name])
