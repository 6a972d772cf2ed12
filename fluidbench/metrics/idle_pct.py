"""Share of the measured window's time a unit in which a card runs neither
a kernel, a copy nor a fill, the mean of the cards' shares: the traced
window's busy device time a unit (the mean over the cards), over the
measured (untraced) window's time a unit. The traced window
itself runs slower than the measured one by the profiler's own host cost
(0.97-1.48 times on an H100), which would read as idle time on the card."""

from fluidbench.metrics import unit_s


def read(ctx, args):
    d, per_unit = ctx["digest"], unit_s(ctx)
    if per_unit is None:
        return None
    return 100.0 * (1.0 - d.busy_us() * 1e-6 / d.units / per_unit)
