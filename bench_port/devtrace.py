"""The device trace of a traced window, reduced to what the metrics read.

`DeviceTrace` runs torch.profiler (CPU and CUDA activities) from `start()`
to `stop()`, between two marker annotations, and keeps:

* `window_s`: from the first traced device operation (work launched before
  the start is not traced) to the stop marker, on the profiler's clock;
  `host_start` / `host_stop` give that window on time.perf_counter;
* `busy_s`: the union of the intervals in which an operation (kernel,
  copy, set) ran on the device, clipped to the window;
* `kernels`: per name, the launch count and summed seconds;
* `idle_gaps`: the device's idle time between operations, summed by what
  the host was doing at each gap's middle (the innermost host event that
  spans it: an aten op, a CUDA runtime call, a `bench:` annotation), or
  "python (no traced op)".

A trace with no device event leaves `busy_s` None: no metric reads it.
From `start()` to the end of `stop()` a watchdog runs: a trace still open
after `limit_s` dumps every thread's stack to stderr and ends the process
with code 1, so a hung profiler fails the run instead of holding it.
"""

from __future__ import annotations

import bisect
import faulthandler
import time
from typing import Dict, List, Optional, Tuple

START, STOP = "bench:trace_start", "bench:trace_stop"
LONG_NS = 1_000_000  # host events of 1 ms or more are searched whole
SMALL_GAP_NS = 10_000
SMALL_GAP = "gaps under 10 us (launch to launch)"


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every traced event. A user
    annotation's span on the device (a `bench:` range) is no operation and
    is left out."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        device = e.device_type() == DeviceType.CUDA
        if device and (e.name().startswith("bench:") or _annotation(e)):
            continue
        start = e.start_ns()
        out.append((e.name(), device, start, start + e.duration_ns()))
    return out


def _annotation(e) -> bool:
    """Whether a device event is a user annotation's span (older torch has
    no activity_type; its device annotations carry the user's names)."""
    kind = getattr(e, "activity_type", None)
    return kind is not None and "annotation" in str(kind())


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


class DeviceTrace:
    def __init__(self, limit_s: float = 240.0):
        self.limit_s = limit_s
        self.prof = None
        self.halted = False
        self.window_s: Optional[float] = None
        self.busy_s: Optional[float] = None
        self.kernels: Dict[str, Tuple[int, float]] = {}
        self.idle_gaps: Dict[str, float] = {}
        self.host_start = self.host_stop = 0.0  # the window on time.perf_counter

    def start(self) -> None:
        import torch
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile, record_function

        faulthandler.dump_traceback_later(self.limit_s, exit=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        # the server's predicts run on its own threads: profile every thread
        self.prof = profile(activities=activities, experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self.prof.start()
        with record_function(START):
            pass
        self.host_start = time.perf_counter()

    def halt(self) -> None:
        """Stop the profiler; `stop()` then reduces what it recorded."""
        from torch.profiler import record_function

        self.host_stop = time.perf_counter()
        with record_function(STOP):
            pass
        self.prof.stop()
        self.halted = True

    def stop(self) -> None:
        if not self.halted:
            self.halt()
        self._reduce(_events(self.prof))
        self.prof = None
        faulthandler.cancel_dump_traceback_later()

    def _reduce(self, events) -> None:
        marks = {name: (a, b) for name, dev, a, b in events if name in (START, STOP) and not dev}
        lo, hi = marks[START][1], marks[STOP][0]
        device = [(a, b, name) for name, dev, a, b in events if dev and b > lo and a < hi]
        if not device:
            self.window_s = (hi - lo) / 1e9
            return
        # Work launched before the start is not traced, though the device may
        # still run it: the window opens at the first traced operation.
        first = min(a for a, _, _ in device)
        self.host_start += max(0, first - lo) / 1e9
        lo = max(lo, first)
        self.window_s = (hi - lo) / 1e9
        device = [(a, b, name) for a, b, name in device if b > lo]
        for a, b, name in device:
            n, s = self.kernels.get(name, (0, 0.0))
            self.kernels[name] = (n + 1, s + (b - a) / 1e9)
        busy = _union([(max(a, lo), min(b, hi)) for a, b, _ in device])
        self.busy_s = sum(b - a for a, b in busy) / 1e9
        host = [(a, b, name) for name, dev, a, b in events if not dev and name not in (START, STOP)]
        short = sorted(e for e in host if e[1] - e[0] < LONG_NS)
        long = [e for e in host if e[1] - e[0] >= LONG_NS]
        starts = [a for a, _, _ in short]
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        for gap_a, gap_b in zip(edges[0::2], edges[1::2]):
            if gap_b <= gap_a:
                continue
            label = SMALL_GAP if gap_b - gap_a < SMALL_GAP_NS else self._host_at(short, starts, long, (gap_a + gap_b) // 2)
            self.idle_gaps[label] = self.idle_gaps.get(label, 0.0) + (gap_b - gap_a) / 1e9

    @staticmethod
    def _host_at(short, starts, long, t: int) -> str:
        """The shortest host event that spans time t: among the short
        events that start shortly before t, else among the long ones."""
        best, best_len = "python (no traced op)", None
        i = bisect.bisect_right(starts, t)
        for a, b, name in short[max(0, i - 256):i]:
            if b >= t and (best_len is None or b - a < best_len):
                best, best_len = name, b - a
        if best_len is None:
            for a, b, name in long:
                if a <= t <= b and (best_len is None or b - a < best_len):
                    best, best_len = name, b - a
        return best

    def kernel(self, substring: str) -> Tuple[int, float]:
        """(launches, seconds) of the device operations whose name holds `substring`."""
        hits = [v for k, v in self.kernels.items() if substring in k]
        return sum(n for n, _ in hits), sum(s for _, s in hits)

    @property
    def launches(self) -> int:
        return sum(n for n, _ in self.kernels.values())

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = sorted(((name[:160], s) for name, (_, s) in self.kernels.items()), key=lambda kv: -kv[1])[:top]
        gaps = sorted(((name[:160], s) for name, s in self.idle_gaps.items()), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [list(x) for x in ops], "idle_gaps": [list(x) for x in gaps]}
