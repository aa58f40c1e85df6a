"""The grouped expert products' share of their roofline in the traced window: the summed least time of their launches (each the larger of its bytes at the HBM rate and its FLOPs at the bf16 peak; bytes of the experts each launch touched, from the passes' expert load, and its activations) over their summed measured time (yardstick_moe.py)."""

from _read import *  # noqa: F401,F403


def read(ctx):
    tr, facts = traced(ctx)
    if tr is None or not facts.get("moe_bound_s"):
        return None
    n, seconds = tr.kernel("moe_gemm_kernel")
    return 100.0 * facts["moe_bound_s"] / seconds if n else None
