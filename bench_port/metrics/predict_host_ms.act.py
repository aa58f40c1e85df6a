"""The predict's host work per action: predict:prepare (stats, tokenize, pad, frames), graphs:copy_in (the static buffers) and predict:unpack spans of each serve:pass just before the trace (_spans.py), ms."""

from _spans import *  # noqa: F401,F403


def read(ctx):
    return per_action(ctx, ("predict:prepare", "graphs:copy_in", "predict:unpack"))
