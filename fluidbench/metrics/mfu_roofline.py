"""The whole unit's share of the card's roofline peak: the sum over every
pass of its bound, max(bytes / bandwidth, operations / float32 peak), over
the measured window's time a unit (the traced window runs slower by the
profiler's own host cost).

It is the step's share of the peak, not of float32 operations alone: every
pass here is bound by bandwidth, so operations alone would read a few
tenths of a percent whatever the kernels did. A pass's roofline reads only
the kernels mapped to it, so work moved off them leaves that roofline
silent; this sum still counts the work, against the whole window, idle
time included, and so bounds what the rooflines can claim."""

from fluidbench.metrics.roofline_pct import bound_s
from fluidbench.metrics import unit_s
from fluidbench.work import passes


def read(ctx, args):
    bound, per_unit = sum(bound_s(ctx, p) for p in passes()), unit_s(ctx)
    return 100.0 * bound / per_unit if bound > 0 and per_unit is not None else None
