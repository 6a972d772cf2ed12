"""The velocity's self-advection: the velocity read and written; 20
operations a texel for the backtrace and decay, 8 a channel's lerps."""

from fluidbench.work import costs


def work(s):
    (h, w), n = costs.grids(s.cfg)["sim"], s.sims
    return s.steps * n * h * w * s.item * 4, s.steps * n * h * w * (20 + 2 * 8)


