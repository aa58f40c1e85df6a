"""Arithmetic the per-layer readers share. A reader gets the driver's
facts (`ctx`): "counters" (the server's across the window), "trace" (a
devtrace.DeviceTrace of the traced window) and "traced" (what the driver
counted in that window: actions or steps, useful FLOPs, each flash kernel's
least time per launch). It returns a number, or None where there is nothing
to read; a share of a roofline or of a peak is never made up as 0."""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import yardstick  # noqa: E402


def traced(ctx: Dict):
    tr = ctx.get("trace")
    if tr is None or tr.busy_s is None or not ctx.get("traced"):
        return None, None
    return tr, ctx["traced"]


def per_unit_launches(ctx: Dict, unit: str) -> Optional[float]:
    tr, facts = traced(ctx)
    if tr is None or not facts.get(unit):
        return None
    return tr.launches / facts[unit]


def idle_share(ctx: Dict) -> Optional[float]:
    tr, _ = traced(ctx)
    if tr is None or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu(ctx: Dict) -> Optional[float]:
    tr, facts = traced(ctx)
    if tr is None or not facts.get("useful_flops") or not tr.window_s:
        return None
    return 100.0 * facts["useful_flops"] / tr.window_s / yardstick.MFU_PEAK


def roofline(ctx: Dict, kernels: Sequence[str]) -> Optional[float]:
    """100 x the summed least time of the kernels' launches in the trace over
    their summed measured time."""
    tr, facts = traced(ctx)
    if tr is None:
        return None
    bound, spent = 0.0, 0.0
    for name in kernels:
        per_launch = facts.get("flash_bound_per_launch_s", {}).get(name)
        n, seconds = tr.kernel(name)
        if n == 0 or per_launch is None:
            return None
        bound += n * per_launch
        spent += seconds
    return 100.0 * bound / spent
