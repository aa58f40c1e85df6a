"""The flash forward's (Dqk 192, Dv 128) latent-attention instance's share of its roofline in the traced window: the least time of its launches at the shapes served (Dqk and Dv counted apart, yardstick_moe.py) over their measured time."""

from _read import *  # noqa: F401,F403


def read(ctx):
    return roofline(ctx, ("flash_fwd_bf16_kernel<192",))
