"""Useful FLOPs of the actions served in the traced window (towers, projector, prefill over the real tokens, decode steps) over its seconds, as a share of the bf16 peak."""

from _read import *  # noqa: F401,F403


def read(ctx):
    return mfu(ctx)
