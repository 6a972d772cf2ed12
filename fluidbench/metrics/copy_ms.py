"""Device milliseconds a unit in copies between two cards ("Memcpy PtoP"
in the trace), summed over the cards. A cell on one card makes none, and
reads nothing."""

from fluidbench import devtrace


def read(ctx, args):
    d = ctx["digest"]
    us = [e.dur for e in d.device if devtrace.kind(e.name) == "copy_ptop"]
    return sum(us) / d.units / 1e3 if us else None
