"""The flash kernels' (forward, dq, dk/dv) share of their roofline over the traced train steps."""

from _read import *  # noqa: F401,F403


def read(ctx):
    return roofline(ctx, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
