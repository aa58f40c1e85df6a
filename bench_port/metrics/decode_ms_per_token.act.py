"""Device time from token 0 to the last id per decode step (the pass's tokens - 1) and action, from the device marks each serve:pass just before the trace carries (_spans.py), ms/token."""

from _spans import *  # noqa: F401,F403


def read(ctx):
    return device_per_action(ctx, "decode_ms", per_token=True)
