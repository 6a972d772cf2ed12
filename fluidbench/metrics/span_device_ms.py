"""Device milliseconds a unit of the kernels, copies and fills whose launch
fell while ``<span>`` was the innermost open program span (``outside``: in
none), in the traced window (fluidbench/programspans.py)."""

from fluidbench.programspans import value


def read(ctx, args):
    return value(ctx, "device_ms", args)
