"""Device-idle milliseconds a unit whose middle fell while ``<span>`` was
the innermost open program span (``outside``: in none: the harness between
calls and its sync after a tick), in the traced window
(fluidbench/programspans.py). Summed over the spans and ``outside`` they are
the traced window's idle time a unit."""

from fluidbench.programspans import value


def read(ctx, args):
    return value(ctx, "idle_ms", args)
