"""Device time of the step's forward (cast, preprocessing, forward, chunked CE) per step, from the step's device marks, over the steps just before the trace (_spans.py), ms."""

from _spans import *  # noqa: F401,F403


def read(ctx):
    return step_mean(ctx, "forward_ms")
