"""Fault tolerance: step watchdog and restart supervisor.

Part-port of ``src/repro/distributed/fault_tolerance.py``: the pieces the
train loop uses, :class:`StepWatchdog` (per-step wall-time monitor: a
step over ``p95 * straggler_factor`` is flagged, one over
``p50 * hang_factor`` raises so the supervisor restarts) and
:func:`run_with_restarts`.  The elastic re-mesh
(``healthy_device_mesh``) waits for the distributed slice (ROADMAP.md,
queue A item 8).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class WatchdogReport:
    step: int
    duration_s: float
    p50: float
    p95: float
    straggler: bool


class StepWatchdog:
    def __init__(self, straggler_factor: float = 1.5,
                 hang_factor: float = 10.0, warmup_steps: int = 5):
        self.straggler_factor = straggler_factor
        self.hang_factor = hang_factor
        self.warmup_steps = warmup_steps
        self.durations: list[float] = []
        self.straggler_events: list[WatchdogReport] = []

    def _quantile(self, q: float) -> float:
        xs = sorted(self.durations)
        if not xs:
            return float("inf")
        return xs[min(int(q * len(xs)), len(xs) - 1)]

    def observe(self, step: int, duration_s: float) -> WatchdogReport:
        p50, p95 = self._quantile(0.5), self._quantile(0.95)
        straggler = (len(self.durations) >= self.warmup_steps
                     and duration_s > p95 * self.straggler_factor)
        report = WatchdogReport(step, duration_s, p50, p95, straggler)
        if straggler:
            self.straggler_events.append(report)
        if (len(self.durations) >= self.warmup_steps
                and duration_s > max(p50, 1e-9) * self.hang_factor):
            raise TimeoutError(
                f"step {step} took {duration_s:.2f}s (p50 {p50:.2f}s) — "
                f"presumed hung host, forcing restart")
        self.durations.append(duration_s)
        return report


def run_with_restarts(run: Callable[[int], int], *, max_restarts: int = 3,
                      on_failure: Callable[[BaseException], None] | None = None
                      ) -> int:
    """Supervisor: ``run(start_step) -> final_step``; on a recoverable
    exception call again with ``start_step = -1`` (restore from the last
    checkpoint), at most ``max_restarts`` times.  Returns the final
    step."""
    restarts = 0
    start_step = 0
    while True:
        try:
            return run(start_step)
        except (TimeoutError, RuntimeError, OSError) as e:  # recoverable
            restarts += 1
            if on_failure:
                on_failure(e)
            if restarts > max_restarts:
                raise
            start_step = -1
            time.sleep(0.01)
