"""Phase timing and throughput counters.

The reference only logs timestamped phase messages
(src/clusterer.rs:27-30,56,81-87); here phases are timed explicitly,
genome-pairs/s counters are recorded, and the whole run can be dumped
as JSON (--metrics-json).

The port's own copy of galah_tpu/utils/metrics.py, so that the port
imports nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

import json
import logging
import time
from contextlib import contextmanager
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class RunMetrics:
    def __init__(self) -> None:
        self.phases: Dict[str, float] = {}
        self.counters: Dict[str, float] = {}
        self._rate_acc: Dict[str, tuple] = {}
        self._start = time.perf_counter()

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            logger.info("phase %s took %.2fs", name, dt)

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def rate(self, name: str, value: float, seconds: float) -> None:
        """Record a throughput counter. Repeated calls under the same
        name accumulate (value, seconds), so runs with several screen/
        verify passes report the aggregate rate — matching the summed
        phase timers — not just the last pass's."""
        if seconds > 0:
            v, t = self._rate_acc.get(name, (0.0, 0.0))
            v += value
            t += seconds
            self._rate_acc[name] = (v, t)
            self.counters[name] = v / t
            logger.info("%s: %.4g/s", name, value / seconds)

    def to_dict(self) -> dict:
        return {
            "wall_clock_s": time.perf_counter() - self._start,
            "phases_s": self.phases,
            "counters": self.counters,
        }

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)


_CURRENT: Optional[RunMetrics] = None


def current() -> RunMetrics:
    global _CURRENT
    if _CURRENT is None:
        _CURRENT = RunMetrics()
    return _CURRENT


def reset() -> RunMetrics:
    global _CURRENT
    _CURRENT = RunMetrics()
    return _CURRENT
