"""The flash forward kernels' share of their roofline in the traced window: the least time of their launches at the shapes served over their measured time."""

from _read import *  # noqa: F401,F403


def read(ctx):
    return roofline(ctx, ("flash_fwd",))
