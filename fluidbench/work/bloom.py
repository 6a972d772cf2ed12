"""The bloom pyramid after its base resample: the base read and the result
written (the mips between are the pass's own); every stage's blur."""

from fluidbench.reference import geometry
from fluidbench.work import costs


def work(s):
    if not (s.frames and s.cfg["BLOOM"]):
        return 0, 0
    mips = geometry.bloom_mips(s.cfg)
    if len(mips) < 2:
        return 0, 0
    bh, bw = costs.grids(s.cfg)["bloom"]
    return 2 * s.sims * 3 * bh * bw * 4, s.sims * costs.pyramid_flops((bh, bw), mips)
