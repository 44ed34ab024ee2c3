"""Phase timing for the engine's /metrics (copy of rama_tpu/utils/profiling.py
without the jax.profiler trace helper).

`PhaseTimer` accumulates named host-clock phase durations (prefill, decode
tick, emit). On the card a phase that ends in a device sync measures device
work plus host overhead; one that does not measures the enqueue only.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class PhaseTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def stats(self) -> dict:
        return {name: {"total_s": round(self.totals[name], 4),
                       "count": self.counts[name],
                       "mean_ms": round(1e3 * self.totals[name]
                                        / max(self.counts[name], 1), 3)}
                for name in self.totals}
