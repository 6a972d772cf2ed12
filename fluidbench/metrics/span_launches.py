"""Kernels a unit, the program's and PyTorch's, whose launch fell while
``<span>`` was the innermost open program span (``outside``: in none), in
the traced window (fluidbench/programspans.py). Summed over the spans and
``outside`` they are ``launches``."""

from fluidbench.programspans import value


def read(ctx, args):
    return value(ctx, "launches", args)
