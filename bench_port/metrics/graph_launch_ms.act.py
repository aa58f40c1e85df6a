"""The host's time in the graph replay calls per action: the graphs:replay spans of each serve:pass just before the trace (_spans.py), ms."""

from _spans import *  # noqa: F401,F403


def read(ctx):
    return per_action(ctx, ("graphs:replay",))
