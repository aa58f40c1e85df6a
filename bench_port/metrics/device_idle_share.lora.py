"""Share of the traced train steps' window in which no operation ran on the device."""

from _read import *  # noqa: F401,F403


def read(ctx):
    return idle_share(ctx)
