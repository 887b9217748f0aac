"""Running meters (reference utils.py:90-110) + a step-time profiler.

The port's copy of `sos_tpu/utils/meters.py`.
"""

from __future__ import annotations

import time
from typing import Optional


class AverageMeter:
    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1) -> None:
        self.val = float(value)
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


class StepTimer:
    """Wall-clock step timing with EMA; the reference has only tqdm bars
    (SURVEY.md §5 'tracing: none') — this is the minimal observability the
    rebuild adds."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg_s: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.avg_s = dt if self.avg_s is None else (
            self.ema * self.avg_s + (1 - self.ema) * dt)
        return dt

    @property
    def steps_per_sec(self) -> float:
        return 1.0 / self.avg_s if self.avg_s else 0.0
