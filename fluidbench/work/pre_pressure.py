"""The pre-pressure chain (splat into the velocity, curl, confinement,
divergence): the velocity and its splat factors read, the velocity and the
divergence written."""

from fluidbench.work import costs


def work(s):
    (h, w), n = costs.grids(s.cfg)["sim"], s.sims
    rows = s.cfg["MAX_SPLATS"]
    factors = 4 * n * rows * (h + w + 2)
    nbytes = s.steps * (n * h * w * s.item * (2 + 2 + 1) + factors)
    ops = h * w * (2 * 2 * s.active + s.steps * n * costs.PRE_PRESSURE)
    return nbytes, ops
