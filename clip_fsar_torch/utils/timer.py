"""Wall-clock timer (counterpart of clip_fsar_tpu/utils/timer.py)."""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._start = None
        self._total = 0.0
        self._count = 0

    def tic(self) -> None:
        self._start = time.perf_counter()

    def toc(self) -> float:
        if self._start is None:
            return 0.0
        dt = time.perf_counter() - self._start
        self._total += dt
        self._count += 1
        self._start = None
        return dt

    @property
    def seconds(self) -> float:
        return self._total if self._count else 0.0

    @property
    def avg_seconds(self) -> float:
        return self._total / self._count if self._count else 0.0
