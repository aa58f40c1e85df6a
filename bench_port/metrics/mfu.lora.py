"""Useful FLOPs of the traced train steps (the LoRA count) over the window's seconds, as a share of the bf16 peak."""

from _read import *  # noqa: F401,F403


def read(ctx):
    return mfu(ctx)
