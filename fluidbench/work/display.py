"""The display composite: the dye texels its taps touch, the bloom, the
sunrays and the dither tile read, the RGBA frame written in float32."""

from fluidbench.work import costs


def work(s):
    if not s.frames:
        return 0, 0
    cfg, grids, n = s.cfg, costs.grids(s.cfg), s.sims
    dye_hw, out_hw = grids["dye"], grids["canvas"]
    extras = {}
    nbytes = n * 3 * s.item * costs.dye_texels_read(dye_hw, out_hw, cfg["SHADING"])
    if cfg["BLOOM"]:
        bh, bw = grids["bloom"]
        extras["bloom"] = (bh, bw)
        extras["dither"] = (64, 64)
        nbytes += n * 3 * bh * bw * 4 + 64 * 64 * 4
    if cfg["SUNRAYS"]:
        rh, rw = grids["sunrays"]
        extras["sunrays"] = (rh, rw)
        nbytes += n * rh * rw * 4
    nbytes += 4 * n * 4 * out_hw[0] * out_hw[1]
    return nbytes, n * costs.display_flops(dye_hw, out_hw, 3, cfg["SHADING"], extras)
