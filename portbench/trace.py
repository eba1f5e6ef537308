"""The traced job: torch.profiler over one whole job, and a sampler of
the host's Python stack beside it.

No Chrome trace is written. From the profiler the harness keeps each
device event's name, start and length (kernels, copies and sets); from
the sampler, every 2 ms, the innermost frame of the program that the
main thread was in. From those:

- ``busy_s``: the union of the device events' intervals;
- ``device_s``: device seconds by event name;
- ``idle_gaps``: the time the device was idle, by what the host was
  doing then.
"""

from __future__ import annotations

import bisect
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

PROGRAM = "galah_tpu_torch"
MARKER = "portbench.job"


class HostSampler:
    """Samples the innermost frame of `PROGRAM` on one thread's stack
    (else the innermost frame) every `interval` seconds, with
    time.time_ns(), the profiler's clock."""

    def __init__(self, thread_id: int, interval: float = 0.002) -> None:
        self.thread_id = thread_id
        self.interval = interval
        self.samples: List[Tuple[int, str]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def label(frame) -> str:
        inner = None
        while frame is not None:
            mod = frame.f_globals.get("__name__", "?")
            name = f"{mod}.{frame.f_code.co_qualname}"
            if inner is None:
                inner = name
            if mod.split(".")[0] == PROGRAM:
                return name
            frame = frame.f_back
        return inner or "?"

    def _run(self) -> None:
        while not self._stop.is_set():
            frame = sys._current_frames().get(self.thread_id)
            if frame is not None:
                self.samples.append((time.time_ns(), self.label(frame)))
            del frame
            self._stop.wait(self.interval)

    def __enter__(self) -> "HostSampler":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        if self._thread.is_alive():
            raise RuntimeError("host sampler did not stop")


@dataclass
class TraceResult:
    window_s: float
    busy_s: float
    device_s: Dict[str, float]
    idle_gaps: List[Tuple[str, float]]
    events: int
    samples: int
    extra: Dict[str, float] = field(default_factory=dict)


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged, sorted intervals."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def idle_by_label(busy: List[Tuple[int, int]], lo: int, hi: int,
                  samples: List[Tuple[int, str]], interval_ns: int
                  ) -> Dict[str, float]:
    """Seconds of idle device time in [lo, hi] by the sampled host label:
    each sample stands for the time to the next one (at most two
    intervals), cut to the idle parts of it."""
    starts = [s for s, _ in busy]
    out: Dict[str, float] = {}
    for i, (ts, label) in enumerate(samples):
        end = samples[i + 1][0] if i + 1 < len(samples) else ts + interval_ns
        end = min(end, ts + 2 * interval_ns, hi)
        ts = max(ts, lo)
        if end <= ts:
            continue
        idle = end - ts
        j = bisect.bisect_right(starts, end) - 1
        while j >= 0 and busy[j][1] > ts:
            idle -= max(0, min(end, busy[j][1]) - max(ts, busy[j][0]))
            j -= 1
        if idle > 0:
            out[label] = out.get(label, 0.0) + idle / 1e9
    return out


def _device_events(prof):
    """(name, start ns, end ns) of the device's events, and the marker's
    (start, end) on the profiler's clock (None if absent)."""
    from torch.autograd import DeviceType

    dev = []
    marker = None
    for e in prof.profiler.kineto_results.events():
        if e.name() == MARKER:
            # The range is recorded on the host and again as a device
            # annotation over the kernels inside it; neither is device work.
            if e.device_type() != DeviceType.CUDA and marker is None:
                marker = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            dev.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return dev, marker


def traced(job: Callable[[], None], on_card: bool = True) -> TraceResult:
    """Run `job` under torch.profiler (CPU, and CUDA on a card) and the
    sampler, and reduce what they saw."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    sampler = HostSampler(threading.get_ident())
    with profile(activities=activities, record_shapes=False,
                 with_stack=False) as prof:
        with sampler:
            w0 = time.time_ns()
            t0 = time.perf_counter()
            with record_function(MARKER):
                job()
                if on_card:
                    torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
            w1 = time.time_ns()
    t_reduce = time.perf_counter()
    dev, marker = _device_events(prof)
    lo, hi = marker if marker is not None else (w0, w1)
    # Samples carry time.time_ns(); shift them onto the profiler's clock.
    shift = lo - w0
    samples = [(ts + shift, lab) for ts, lab in sampler.samples]
    busy = union([(max(s, lo), min(e, hi)) for _, s, e in dev
                  if e > lo and s < hi])
    busy_s = sum(e - s for s, e in busy) / 1e9
    device_s: Dict[str, float] = {}
    for name, s, e in dev:
        device_s[name] = device_s.get(name, 0.0) + (e - s) / 1e9
    gaps = idle_by_label(busy, lo, hi, samples,
                         int(sampler.interval * 1e9))
    idle = sorted(gaps.items(), key=lambda t: -t[1])
    return TraceResult(
        window_s=window_s, busy_s=busy_s, device_s=device_s, idle_gaps=idle,
        events=len(dev), samples=len(samples),
        extra={"clock_shift_ms": shift / 1e6,
               "reduce_s": time.perf_counter() - t_reduce})
