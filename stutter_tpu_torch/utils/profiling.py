"""Per-stage wall-clock counters (counterpart of StageTimer in
stutter_tpu/utils/profiling.py); the corpus entry points log a stage
report to the `stutter_tpu_torch.profiling` logger."""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict

log = logging.getLogger("stutter_tpu_torch.profiling")


class StageTimer:
    """Accumulates wall-clock per named stage; thread-unsafe by design (cheap)."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{'stage':28s} {'total_s':>9s} {'calls':>6s} {'per_call_ms':>12s}"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:28s} {total:9.3f} {n:6d} {total / n * 1000:12.2f}")
        return "\n".join(lines)

    def log_report(self):
        for line in self.report().splitlines():
            log.info(line)
