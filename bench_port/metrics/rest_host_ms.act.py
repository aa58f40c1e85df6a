"""The REST layer's host time per request: its serve:parse (body read, JSON, image decode) and serve:respond (encode, JSON, write) spans, over the requests just before the trace (_spans.py), ms."""

from _spans import *  # noqa: F401,F403


def read(ctx):
    return per_request(ctx, ("serve:parse", "serve:respond"))
