"""Device time of every kernel the MoE layers launch (router and top-k, counts and offsets, the grouped gated and down products, the combine: the moe_* kernels) per action in the traced window, ms. The shared experts run through the dense projections and are not counted."""

from _read import *  # noqa: F401,F403


def read(ctx):
    tr, facts = traced(ctx)
    if tr is None or not facts.get("actions"):
        return None
    n, seconds = tr.kernel("::moe_")
    return 1e3 * seconds / facts["actions"] if n else None
