"""Device time from the predict graph's start to token 0 (towers and prefill) per action, from the device marks each serve:pass just before the trace carries (_spans.py), ms."""

from _spans import *  # noqa: F401,F403


def read(ctx):
    return device_per_action(ctx, "prefill_ms")
