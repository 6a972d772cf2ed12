"""The dye's advection with the dye splat fused in: the velocity, the dye
and the splat factors read once, the dye written once; a texel 34
operations for the velocity's sample and the backtrace, 8 a channel's
lerps, 40 for RGB9E5, and 2 a channel and active splat."""

from fluidbench.work import costs


def work(s):
    grids, n = costs.grids(s.cfg), s.sims
    (sh, sw), (h, w) = grids["sim"], grids["dye"]
    rows = s.cfg["MAX_SPLATS"]
    factors = 4 * n * rows * (h + w + 3)
    nbytes = s.steps * (n * s.item * (2 * sh * sw + 3 * h * w + 3 * h * w) + factors)
    per_texel = 34 + 3 * 8 + (40 if costs.quant(s.cfg) else 0)
    return nbytes, h * w * (s.steps * n * per_texel + 3 * 2 * s.active)
