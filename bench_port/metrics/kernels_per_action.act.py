"""Device operations launched in the traced window per action completed in it (profiler)."""

from _read import *  # noqa: F401,F403


def read(ctx):
    return per_unit_launches(ctx, "actions")
