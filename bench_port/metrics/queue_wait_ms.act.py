"""A request's wait for the model: its serve:wait span (the model lock at max_batch 1, else the batcher's queue from put to the pass's start), over the requests just before the trace (_spans.py), ms."""

from _spans import *  # noqa: F401,F403


def read(ctx):
    return per_request(ctx, ("serve:wait",))
