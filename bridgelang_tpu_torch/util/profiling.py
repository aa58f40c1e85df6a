"""Tracing of the port: host spans, device marks, counters and the profiler.

Counterpart of bridgelang_tpu/util/profiling.py, and the port's one tracing
module.

* `span(name, rid=None, **attrs)`: a context manager that records one span:
  an id, the id of the thread's enclosing span (its parent), a request id
  (given, else the parent's), the name, the thread, start and end on
  `time.perf_counter_ns()` and optional attrs. Finished spans go into one
  bounded ring per process (`RING_SIZE` records; the oldest drop out).
  While a torch profiler records, a span is also a RecordFunction range of
  the same name, so it lands in the profiler's trace as a host op and names
  the device's idle gaps under it. It is entered as a host op
  (`_RecordFunctionFast`), not as a `record_function` user annotation: the
  profiler lays an annotation that encloses kernels on the device's
  timeline as well, where a device trace would count it as device time
  (torch 2.11 on an H100 does). Spans are always
  on; they wrap requests, passes and step phases, never a layer or a
  kernel, and none of them synchronises the device.
  `span(..., ends_parent=True)` is its parent's last child: the parent ends
  when it does, at the same clock read. The server's `serve:respond` ends
  `serve:request` so: once the reply is written, the thread may wait for
  the GIL (an in-process client's thread takes it as its reply arrives)
  before its frames unwind to the request's own exit, and that wait is no
  part of serving the request.
* `note(**attrs)` adds attrs to the thread's innermost open span;
  `record(...)` adds a span whose times were taken elsewhere (a queued
  request's wait, closed by the thread that takes it).
* `DeviceMarks`: CUDA timing events at named points of a predict or a step
  (`mark(name)` records one into the marks `marking(marks)` made active on
  this thread). Recorded during a CUDA graph capture with `external=True`,
  they are part of the graph and time every replay. They are read once the
  work behind them has completed, without waiting for it: at once after a
  device-to-host copy, or lazily through `resolve_later` / `resolve`.
* `count(name, n)`: monotonic integer counters; `counters()` reads them.
* Readers: `spans(t0_ns, t1_ns, name)` the records that end in a window,
  `stage_summary()` each name's count and p50 / p99 of its last
  `SUMMARY_SPANS` spans (kept per name as each span ends, so the summary
  does not scan the ring),
  `dump(path)` the ring as Chrome-trace JSON.
* `trace(logdir)`: torch.profiler over the body, written as a Chrome trace.
* `device_memory_stats()`: live and peak memory per card; {} without one.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

RING_SIZE = 65_536
SUMMARY_SPANS = 512  # the recent spans of each name that stage_summary reads

_ring: "collections.deque[Span]" = collections.deque(maxlen=RING_SIZE)
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_local = threading.local()
_counters: Dict[str, int] = {}
_counter_lock = threading.Lock()
_ended: Dict[str, int] = {}  # spans ended per name
_recent: "Dict[str, collections.deque[float]]" = {}  # ms of each name's last SUMMARY_SPANS spans
_summary_lock = threading.Lock()
_pending_lock = threading.Lock()
_pending: "collections.deque[Tuple[DeviceMarks, Span, Dict[str, Tuple[str, str]]]]" = collections.deque(maxlen=256)


class Span:
    """One finished (or open) span; times in ns on time.perf_counter_ns()."""

    __slots__ = ("id", "parent", "rid", "name", "thread", "t0", "t1", "attrs")

    def __init__(self, id: int, parent: Optional[int], rid: Optional[int], name: str, thread: int, t0: int,
                 t1: int = 0, attrs: Optional[Dict[str, Any]] = None):
        self.id, self.parent, self.rid, self.name, self.thread = id, parent, rid, name, thread
        self.t0, self.t1, self.attrs = t0, t1, attrs if attrs is not None else {}

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, rid={self.rid}, {self.ms:.3f} ms, "
                f"{self.attrs})")


def _finish(rec: Span) -> None:
    """File a finished span: the ring, and its name's count and recent times."""
    _ring.append(rec)
    ms = rec.ms
    with _summary_lock:
        recent = _recent.get(rec.name)
        if recent is None:
            recent = _recent[rec.name] = collections.deque(maxlen=SUMMARY_SPANS)
        recent.append(ms)
        _ended[rec.name] = _ended.get(rec.name, 0) + 1


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def new_request_id() -> int:
    return next(_request_ids)


def current() -> Optional[Span]:
    """The thread's innermost open span."""
    stack = _stack()
    return stack[-1] if stack else None


class span:
    """`with span("serve:pass", rows=4) as s:` records a Span (see the module
    docstring); `s.attrs` may be filled while it is open. `ends_parent`: the
    enclosing span ends with this one."""

    __slots__ = ("name", "rid", "attrs", "rec", "_range", "ends_parent")

    def __init__(self, name: str, rid: Optional[int] = None, ends_parent: bool = False, **attrs):
        self.name, self.rid, self.attrs, self.ends_parent = name, rid, attrs, ends_parent

    def __enter__(self) -> Span:
        stack = _stack()
        parent = stack[-1] if stack else None
        rid = self.rid if self.rid is not None or parent is None else parent.rid
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        self.rec = Span(next(_span_ids), parent.id if parent is not None else None, rid, self.name,
                        threading.get_ident(), time.perf_counter_ns(), 0, self.attrs)
        stack.append(self.rec)
        return self.rec

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        ended = rec.t1 != 0  # a child with `ends_parent` ended it
        if not ended:
            rec.t1 = time.perf_counter_ns()
        stack = _stack()
        if stack and stack[-1] is rec:
            stack.pop()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        if not ended:
            _finish(rec)
            if self.ends_parent and stack and not stack[-1].t1:
                stack[-1].t1 = rec.t1
                _finish(stack[-1])
        return False


def note(**attrs) -> None:
    """Add attrs to the thread's innermost open span (none open: dropped)."""
    rec = current()
    if rec is not None:
        rec.attrs.update(attrs)


def record(name: str, t0_ns: int, t1_ns: int, rid: Optional[int] = None, parent: Optional[int] = None,
           thread: Optional[int] = None, **attrs) -> Span:
    """Add a finished span whose times were taken elsewhere."""
    rec = Span(next(_span_ids), parent, rid, name, thread if thread is not None else threading.get_ident(),
               int(t0_ns), int(t1_ns), attrs)
    _finish(rec)
    return rec


# --- device marks ------------------------------------------------------------------


class DeviceMarks:
    """Timing events at the named points of one piece of device work.
    `external=True` makes a record inside a CUDA graph capture an event
    node of the graph, so every replay records the event again."""

    def __init__(self, names: Sequence[str], external: bool = False):
        self.events = {n: torch.cuda.Event(enable_timing=True, external=external) for n in names}
        self.recorded: set = set()

    def record(self, name: str) -> None:
        self.events[name].record()
        self.recorded.add(name)

    def done(self) -> bool:
        """Whether the device has passed every recorded mark (no wait)."""
        return all(self.events[n].query() for n in self.recorded)

    def elapsed_ms(self, intervals: Dict[str, Tuple[str, str]]) -> Dict[str, float]:
        """{key: ms from mark a to mark b} for each interval both of whose
        marks were recorded. Call once the work has completed."""
        return {key: self.events[a].elapsed_time(self.events[b]) for key, (a, b) in intervals.items()
                if a in self.recorded and b in self.recorded}


@contextlib.contextmanager
def marking(marks: Optional[DeviceMarks]):
    """Make `marks` the thread's active marks for `mark()` (None: no marks)."""
    before = getattr(_local, "marks", None)
    _local.marks = marks
    try:
        yield marks
    finally:
        _local.marks = before


def mark(name: str) -> None:
    """Record the active marks' event `name` on the current stream (a no-op
    without active marks)."""
    marks = getattr(_local, "marks", None)
    if marks is not None:
        marks.record(name)


def resolve_later(marks: DeviceMarks, rec: Span, intervals: Dict[str, Tuple[str, str]]) -> None:
    """Write `marks.elapsed_ms(intervals)` into `rec.attrs` once the device
    has passed the marks (checked by `resolve`, never waited for)."""
    _pending.append((marks, rec, intervals))


def resolve() -> None:
    """Resolve the pending marks whose work has completed, oldest first."""
    with _pending_lock:
        while _pending and _pending[0][0].done():
            marks, rec, intervals = _pending.popleft()
            rec.attrs.update(marks.elapsed_ms(intervals))


# --- counters ----------------------------------------------------------------------


def count(name: str, n: int = 1) -> None:
    with _counter_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters(prefix: str = "") -> Dict[str, int]:
    with _counter_lock:
        return {k: v for k, v in _counters.items() if k.startswith(prefix)}


# --- readers -----------------------------------------------------------------------


def spans(t0_ns: Optional[int] = None, t1_ns: Optional[int] = None, name: Optional[str] = None) -> List[Span]:
    """The ring's records that end in [t0_ns, t1_ns] (either bound open when
    None), with `name` if given, in the order they ended."""
    resolve()
    return [r for r in list(_ring) if (t0_ns is None or r.t1 >= t0_ns) and (t1_ns is None or r.t1 <= t1_ns)
            and (name is None or r.name == name)]


def stage_summary() -> Dict[str, Dict[str, Any]]:
    """{name: {"count", "p50_ms", "p99_ms"}}: "count" is how many spans of
    the name have ended in this process, the percentiles are over the last
    `SUMMARY_SPANS` of them."""
    with _summary_lock:
        by_name = {name: (_ended[name], list(recent)) for name, recent in _recent.items()}
    return {name: {"count": n, "p50_ms": round(float(np.percentile(recent, 50)), 3),
                   "p99_ms": round(float(np.percentile(recent, 99)), 3)}
            for name, (n, recent) in sorted(by_name.items())}


def dump(path: str) -> str:
    """Write the ring as Chrome-trace JSON (chrome://tracing, Perfetto) -> path."""
    pid = os.getpid()
    events = [{"name": r.name, "ph": "X", "ts": r.t0 / 1e3, "dur": (r.t1 - r.t0) / 1e3, "pid": pid,
               "tid": r.thread, "args": dict(r.attrs, id=r.id, parent=r.parent, rid=r.rid)} for r in spans()]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f, default=str)
    return path


# --- the profiler and memory -------------------------------------------------------


@contextlib.contextmanager
def trace(logdir: str, filename: str = "trace.json"):
    """Profile the body with torch.profiler (host ops, and the card's
    kernels when a card is present); writes `<logdir>/<filename>`
    (chrome://tracing, Perfetto) when it ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, filename))


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_gb": stats.get("allocated_bytes.all.current", 0) / 1e9,
            "peak_bytes_gb": stats.get("allocated_bytes.all.peak", 0) / 1e9,
            "bytes_limit_gb": torch.cuda.get_device_properties(i).total_memory / 1e9,
        }
    return out
