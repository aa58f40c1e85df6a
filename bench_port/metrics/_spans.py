"""Program spans around the traced window, for the per-layer readers that
read the port's own spans and device marks (`bridgelang_tpu_torch.util.profiling`,
imported in this process: `drivers/act.py` and `drivers/lora.py` run the
server and the train step here).

They read the untraced stretch of a traced run: as many spans of the name
as end inside the traced window ([host_start, host_stop] of `ctx["trace"]`
on time.perf_counter), the ones that end last before it opens. While the
profiler records, and for the rest of the process after it, host work runs
slower (the graph launch tens to hundreds of times so), and the device
waits on it: inside the predict graph (the prefill's marks) and through the
LoRA step, which is host-bound. The /act readers leave out the last request
before the window: the profiler's start takes the benchmark's gate as that
request's pass releases it, and runs beside the rest of it.

A program without the spans (no `profiling.spans`), or a stretch with none
of them, gives None: the metric is left out of the line."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

SKIP_ACT = 1  # the /act readers' requests left out just before the window (see above)


def window(ctx: Dict) -> Optional[List]:
    """Every record of the program's span ring (children may end before the
    window opens), and the window's bounds in ns, or None."""
    tr = ctx.get("trace")
    if tr is None or not tr.host_stop:
        return None
    try:
        from bridgelang_tpu_torch.util import profiling

        records = profiling.spans()
    except (ImportError, AttributeError):
        return None
    return [records, int(tr.host_start * 1e9), int(tr.host_stop * 1e9)]


def stretch(ctx: Dict, name: str, skip: int = 0):
    """(the untraced stretch's spans named `name`, leaving out the `skip`
    last before the window; children by parent id), or (None, None)."""
    got = window(ctx)
    if got is None:
        return None, None
    records, t0, t1 = got
    kids: Dict[int, List] = {}
    for r in records:
        if r.parent is not None:
            kids.setdefault(r.parent, []).append(r)
    named = sorted((r for r in records if r.name == name), key=lambda r: r.t1)
    inside = sum(1 for r in named if t0 <= r.t1 <= t1)
    before = [r for r in named if r.t1 < t0]
    before = before[:max(0, len(before) - skip)]
    chosen = before[len(before) - inside:] if inside else []
    return (chosen or None), kids


def children_ms(rec, kids: Dict[int, List], names: Sequence[str]) -> float:
    return sum(k.ms for k in kids.get(rec.id, ()) if k.name in names)


def per_request(ctx: Dict, names: Sequence[str]) -> Optional[float]:
    """Mean over the untraced stretch's `serve:request` spans of their children named `names`, ms."""
    reqs, kids = stretch(ctx, "serve:request", SKIP_ACT)
    if reqs is None:
        return None
    return sum(children_ms(r, kids, names) for r in reqs) / len(reqs)


def per_action(ctx: Dict, names: Sequence[str]) -> Optional[float]:
    """The untraced stretch's `serve:pass` spans' children named `names`,
    summed, per request they served (the pass's `rows`), ms."""
    passes, kids = stretch(ctx, "serve:pass", SKIP_ACT)
    if passes is None:
        return None
    rows = sum(p.attrs.get("rows", 1) for p in passes)
    return sum(children_ms(p, kids, names) for p in passes) / rows


def device_per_action(ctx: Dict, key: str, per_token: bool = False) -> Optional[float]:
    """The untraced stretch's `serve:pass` device time `key` (ms, from the
    predict's marks) per request served, and with `per_token` per decode
    step after token 0 (the pass's `tokens` - 1)."""
    passes, _ = stretch(ctx, "serve:pass", SKIP_ACT)
    passes = [p for p in passes or () if key in p.attrs and (not per_token or p.attrs.get("tokens", 0) > 1)]
    if not passes:
        return None
    rows = sum(p.attrs.get("rows", 1) * ((p.attrs["tokens"] - 1) if per_token else 1) for p in passes)
    return sum(p.attrs[key] for p in passes) / rows


def step_mean(ctx: Dict, key: Optional[str] = None) -> Optional[float]:
    """Over the untraced stretch's `train:step` spans: the mean device time
    `key` (ms) of those whose marks were read, or with no key the mean
    span, s."""
    steps, _ = stretch(ctx, "train:step")
    if steps is None:
        return None
    if key is None:
        return sum(s.ms for s in steps) / 1e3 / len(steps)
    values = [s.attrs[key] for s in steps if key in s.attrs]
    return sum(values) / len(values) if values else None
