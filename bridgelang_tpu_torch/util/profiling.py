"""Profiling / tracing (counterpart of bridgelang_tpu/util/profiling.py).

* `trace(logdir)`: context manager around `torch.profiler` writing a Chrome
  trace (host ops, and the card's kernels when a card is present) to
  `<logdir>/trace.json`.
* `annotate(name)`: a `record_function` range for host-side phases, shown
  in the trace.
* `StepTimer`: wall-clock per-step timing that waits for the card first,
  with EMA smoothing.
* `device_memory_stats()`: live and peak memory per card from
  `torch.cuda.memory_stats`; {} without a card, as the JAX package gives
  with no device statistics.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body; writes `<logdir>/trace.json` (chrome://tracing,
    Perfetto) when it ends."""
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
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepTimer:
    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg: Optional[float] = None
        self._t0 = time.time()

    def tick(self, sync_on: Any = None) -> float:
        """Return seconds since the last tick; first waits for the work
        queued on `sync_on`'s stream (a CUDA tensor), so that asynchronous
        launches do not hide device time."""
        if isinstance(sync_on, torch.Tensor) and sync_on.is_cuda:
            torch.cuda.current_stream(sync_on.device).synchronize()
        now = time.time()
        dt = now - self._t0
        self._t0 = now
        self.avg = dt if self.avg is None else self.ema * self.avg + (1 - self.ema) * dt
        return dt


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
