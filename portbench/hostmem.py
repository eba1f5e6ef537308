"""The host memory that this process holds resident, and its peak over a
span, sampled from ``/proc/self/statm`` by a background thread."""

from __future__ import annotations

import os
import resource
import threading

PAGE_BYTES = os.sysconf("SC_PAGE_SIZE")
GIB = float(1 << 30)


def resident_bytes() -> int:
    """Resident bytes of this process now: anonymous, file and shared
    pages that it has mapped."""
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * PAGE_BYTES


def lifetime_peak_bytes() -> int:
    """The kernel's high-water mark of this process's resident bytes."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class PeakSampler:
    """Samples `resident_bytes` every `period_s` between `start` and
    `stop`; `peak` is the largest sample, the first and last included."""

    def __init__(self, period_s: float = 0.005):
        self.period_s = period_s
        self.peak = 0
        self.samples = 0
        self._stop = threading.Event()
        self._thread = None

    def _sample(self) -> None:
        self.peak = max(self.peak, resident_bytes())
        self.samples += 1

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            self._sample()

    def start(self) -> "PeakSampler":
        self._sample()
        self._thread = threading.Thread(target=self._loop,
                                        name="portbench-rss", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> int:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        self._sample()
        return self.peak
