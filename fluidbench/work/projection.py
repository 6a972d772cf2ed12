"""The pressure solve and the gradient subtract: the pressure, the
divergence and the velocity read, the pressure and the velocity written;
a sweep 6 operations a cell, the subtract 4."""

from fluidbench.work import costs


def work(s):
    (h, w), n = costs.grids(s.cfg)["sim"], s.sims
    iters = s.cfg["PRESSURE_ITERATIONS"]
    return (s.steps * n * h * w * s.item * (1 + 1 + 2 + 1 + 2),
            s.steps * n * h * w * (6 * iters + 4))
