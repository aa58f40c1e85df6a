"""The host's time inside the train step (train:step span, entry to return; the step never waits for the card) per step, over the steps just before the trace (_spans.py), s."""

from _spans import *  # noqa: F401,F403


def read(ctx):
    return step_mean(ctx)
