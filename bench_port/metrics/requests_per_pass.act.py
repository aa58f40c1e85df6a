"""Requests per model pass of the REST server's micro-batcher, across the window: the change in /stats requests over the change in model_passes."""

from _read import *  # noqa: F401,F403


def read(ctx):
    return (ctx["counters"]["requests"] / ctx["counters"]["model_passes"]) if ctx.get("counters", {}).get("model_passes") else None
