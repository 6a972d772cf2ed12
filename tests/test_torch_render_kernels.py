"""The structure of the render kernels (csrc/bloom.cu, csrc/display.cu),
held on the CPU: a numpy transliteration in float32, without fused
multiply-adds, of each kernel's indexing, against the kernel's plain
version bit for bit, with inputs made by numpy from a seed at small sizes.

  * The bloom pyramid: the stage split of ops/cuda/bloom.stage_plan (the
    large levels grid-wide, every level from the first small one in one
    block's shared memory, back up to it), the levels laid out in one
    scratch buffer (unwritten texels NaN, so a read of one shows), the up
    stages in place, level `small` written back after the block phase; for
    a batch, the work items of every sim and the block phase a sim at a
    time (tests/test_torch_batch_render.py).
  * The display: per 16x64 output tile, the tap tables, the dye window from
    the first row's lowest tap to the last row's highest, the column stage
    at the tile's columns for every window row and the row stage at the
    tile's rows for every window column, then each texel's lerps.
  * The display's direct form (a window that does not fit a block): per
    16x64 output tile the same tap tables, each texel's taps read from the
    whole dye in the same stage order, at 4x and 16x downsamples.
  * The window that ops/cuda/display.window reports covers every corner a
    tile reads, and fits a block's shared memory, at the full output sizes
    of the render: the canvases, the captures and the 360x640 tick; there
    display.form picks the staged form, and at the small canvases of
    check.DIRECT_GEOMETRIES the direct one.

The kernels' bits on the card: tests/test_torch_kernels.py, chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from tpufluid_torch import FluidConfig
from tpufluid_torch.ops import bloom as tbloom
from tpufluid_torch.ops import display as tdisplay
from tpufluid_torch.ops.cuda import bloom as kbloom
from tpufluid_torch.ops.cuda import check
from tpufluid_torch.ops.cuda import display as kdisplay

f32 = np.float32
# Shared memory a block may opt into on the H100 (sm_90), in bytes.
MAX_SHARED = 232448


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch intra-op thread for this module: the suite runs files in
    parallel workers, and each worker's full thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _axis(k, n_in, n_out, scale=1.0, off=0.0, wrap=False):
    """common.cuh axis_tap for output indices k: (i0, i1, f)."""
    p = ((np.asarray(k).astype(f32) + f32(0.5)) / f32(n_out)) * f32(scale) + f32(off)
    x = p * f32(n_in) - f32(0.5)
    x0 = np.floor(x)
    i = x0.astype(np.int64)
    if wrap:
        return np.mod(i, n_in), np.mod(i + 1, n_in), x - x0
    return np.clip(i, 0, n_in - 1), np.clip(i + 1, 0, n_in - 1), x - x0


def _lerp(a, b, f):
    return a * (f32(1) - f) + b * f


# ---------------------------------------------------------------- bloom

def _blur_stage(src, s_hw, dst, out, o_hw, sims, knee, scaled, curve, intensity):
    """run_stage for every work item of one stage, from flat planes: src
    (sims * 3 * sh * sw), dst and out (sims * 3 * oh * ow); dst may be out.
    Item g, the output's index, is texel g % texels of plane g // texels
    (sim * 3 + channel); the knee reads the three planes of its sim."""
    (sh, sw), (oh, ow) = s_hw, o_hw
    texels = oh * ow
    g = np.arange(sims * 3 * texels)
    plane, t = g // texels, g % texels
    i, j = t // ow, t - (t // ow) * ow
    tx, ty = f32(1.0 / sw), f32(1.0 / sh)
    row, col = _axis(i, sh, oh), _axis(j, sw, ow)
    left, right = _axis(j, sw, ow, off=-tx), _axis(j, sw, ow, off=tx)
    below, above = _axis(i, sh, oh, off=-ty), _axis(i, sh, oh, off=ty)
    hw = sh * sw
    first = plane // 3 * 3

    def fetch(y, x):
        at = y * sw + x
        v = src[plane * hw + at]
        if not knee:
            return v
        threshold, c0, c1, c2 = (f32(v_) for v_ in curve)
        at0 = first * hw + at
        br = np.maximum(np.maximum(src[at0], src[hw + at0]), src[2 * hw + at0])
        rq = np.minimum(np.maximum(br - c0, f32(0)), c1)
        rq = c2 * rq * rq
        return v * (np.maximum(rq, br - threshold) / np.maximum(br, f32(1e-4)))

    def tap(r, q):
        top = _lerp(fetch(r[0], q[0]), fetch(r[0], q[1]), q[2])
        bot = _lerp(fetch(r[1], q[0]), fetch(r[1], q[1]), q[2])
        return _lerp(top, bot, r[2])

    s = tap(row, left)
    s = s + tap(row, right)
    s = s + tap(below, col)
    s = s + tap(above, col)
    s = s * f32(0.25)
    if dst is not None:
        s = dst[g] + s
    if scaled:
        s = s * f32(intensity)
    out[g] = s


def _emulate_pyramid(base, mip_sizes, threshold, soft_knee, intensity, small, blocks=1):
    """bloom_pyramid_kernel's phases in numpy, level by level, for one sim's
    base (3, bh, bw) or a batch's (B, 3, bh, bw): the grid-wide stages over
    the work items of every sim, level k of the batch one (B, 3, h, w) array
    in the scratch buffer at B times one sim's offset; the block phase a sim
    at a time, block b of ``blocks`` taking the sims b, b + blocks, ..., in
    a shared memory of one sim's small levels (NaN again for each sim, so
    that a read of a level the sim has not written shows)."""
    batch = base[None] if base.ndim == 3 else base
    nb, _, bh, bw = batch.shape
    level_hw = [(h, w) for w, h in mip_sizes]
    n = len(level_hw)
    offs = np.cumsum([0] + [3 * h * w for h, w in level_hw])
    scratch = np.full(nb * offs[-1], np.nan, f32)
    out = np.full(nb * 3 * bh * bw, np.nan, f32)
    curve = (threshold,) + tbloom.knee_curve(threshold, soft_knee)

    def where(k, sim=None, smem=None):
        """(flat view, (h, w)) of level k (-1 the base, n the output) of
        every sim, or of sim ``sim``; its small levels from ``smem``."""
        if smem is not None and small <= k < n:
            return smem[offs[k] - offs[small]:offs[k + 1] - offs[small]], level_hw[k]
        if k < 0:
            every, hw = batch.reshape(-1), (bh, bw)
        elif k >= n:
            every, hw = out, (bh, bw)
        else:
            every, hw = scratch[nb * offs[k]:nb * offs[k + 1]], level_hw[k]
        if sim is None:
            return every, hw
        one = 3 * hw[0] * hw[1]
        return every[sim * one:(sim + 1) * one], hw

    def stage(name, k, sim=None, smem=None):
        sims = nb if sim is None else 1
        if name == "down":
            (src, s_hw), (dst, o_hw) = where(k - 1, sim, smem), where(k, sim, smem)
            _blur_stage(src, s_hw, None, dst, o_hw, sims, k == 0, False, curve, intensity)
        elif name == "up":
            (src, s_hw), (m, o_hw) = where(k + 1, sim, smem), where(k, sim, smem)
            _blur_stage(src, s_hw, m, m, o_hw, sims, False, False, curve, intensity)
        else:
            (src, s_hw), (dst, o_hw) = where(0), where(n)
            _blur_stage(src, s_hw, None, dst, o_hw, sims, False, True, curve, intensity)

    for kind, stages in kbloom.stage_plan(n, small):
        if kind == "grid":
            for name, k in stages:
                stage(name, k)
            continue
        for block in range(blocks):
            for sim in range(block, nb, blocks):
                smem = np.full(offs[-1] - offs[small], np.nan, f32)
                for name, k in stages:
                    stage(name, k, sim, smem)
                where(small, sim)[0][:] = where(small, sim, smem)[0]
    return out.reshape(batch.shape if base.ndim == 4 else base.shape)


# (bloom resolution, canvas w x h, BLOOM_ITERATIONS): 2, 3 and 7 mips, odd
# sizes, a base smaller than the small-level threshold.
BLOOM_CASES = [(24, (1280, 720), 8), (37, (333, 201), 3), (64, (1280, 720), 2),
               (40, (256, 256), 8), (96, (1280, 720), 8)]


@pytest.mark.parametrize("res,canvas,iters", BLOOM_CASES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
@pytest.mark.parametrize("small_texels", [None, 0, 60, 10 ** 9],
                         ids=["default", "all-grid", "small-60", "all-block"])
def test_bloom_kernel_structure_equals_plain(res, canvas, iters, small_texels):
    """The kernel's phases, transliterated, give bloom_pyramid_plain's bits
    with the main paths' threshold and with every level in the grid, in the
    block, or split low."""
    cfg = FluidConfig(BLOOM_RESOLUTION=res, CANVAS_WIDTH=canvas[0], CANVAS_HEIGHT=canvas[1],
                      BLOOM_ITERATIONS=iters).validate()
    mips = cfg.bloom_mip_sizes()
    bw, bh = cfg.bloom_size
    assert len(mips) >= 2
    rng = np.random.default_rng(res * 100 + iters)
    base = (rng.random((3, bh, bw)) * 2.0).astype(f32)
    small = kbloom.small_level([(h, w) for w, h in mips],
                               kbloom.SMALL_TEXELS if small_texels is None else small_texels)
    args = (cfg.BLOOM_THRESHOLD, cfg.BLOOM_SOFT_KNEE, cfg.BLOOM_INTENSITY)
    got = _emulate_pyramid(base, mips, *args, small)
    want = kbloom.bloom_pyramid_plain(torch.from_numpy(base), mips, *args).numpy()
    np.testing.assert_array_equal(got, want)


def test_bloom_stage_plan():
    """At both main-path configs (7 mips, m3 the first of <= 512 texels):
    three down stages grid-wide, the block (4 down, 3 up), three up stages
    and the final stage, so 7 grid barriers; every stage of ops/bloom.pyramid
    once, in its order; the block's levels fit shared memory."""
    for canvas in ((1280, 720), (1024, 1024)):
        cfg = FluidConfig(CANVAS_WIDTH=canvas[0], CANVAS_HEIGHT=canvas[1]).validate()
        level_hw = [(h, w) for w, h in cfg.bloom_mip_sizes()]
        n, small = len(level_hw), kbloom.small_level(level_hw)
        assert (n, small) == (7, 3)
        plan = kbloom.stage_plan(n, small)
        assert [k for k, _ in plan] == ["grid"] * 3 + ["block"] + ["grid"] * 4
        assert len(plan[3][1]) == 7
        stages = [s for _, st in plan for s in st]
        assert stages == ([("down", k) for k in range(n)] + [("up", k) for k in range(n - 2, -1, -1)]
                          + [("final", -1)])
        assert sum(12 * h * w for h, w in level_hw[small:]) <= MAX_SHARED
    for n in (2, 3):
        for small in range(n + 1):
            stages = [s for _, st in kbloom.stage_plan(n, small) for s in st]
            assert stages == ([("down", k) for k in range(n)]
                              + [("up", k) for k in range(n - 2, -1, -1)] + [("final", -1)])


# ---------------------------------------------------------------- display

def _sqrt(x):
    """sqrt from the plain version's library: PyTorch's CPU sqrt is not
    always numpy's correctly rounded one (the kernel's sqrtf is held to
    PyTorch's CUDA sqrt on the card)."""
    return torch.sqrt(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def _tables(n_in, n_out, start, count, off, scale=1.0, wrap=False):
    k = np.minimum(start + np.arange(count), n_out - 1)     # past the edge: the last
    return _axis(k, n_in, n_out, scale, off, wrap)


def _sample(tex, r, q):
    """sample_cols_rows of a (h, w) plane at row taps r (per output row) and
    column taps q (per output column) -> (rows, cols)."""
    top = _lerp(tex[r[0][:, None], q[0][None]], tex[r[0][:, None], q[1][None]], q[2][None])
    bot = _lerp(tex[r[1][:, None], q[0][None]], tex[r[1][:, None], q[1][None]], q[2][None])
    return _lerp(top, bot, r[2][:, None])


def _sample_rows_cols(tex, r, q):
    """csrc/display.cu sample_rows_cols of (C, h, w) planes at row taps r
    and column taps q -> (C, rows, cols): rows first, then columns."""
    a = _lerp(tex[:, r[0][:, None], q[0][None]], tex[:, r[1][:, None], q[0][None]], r[2][:, None])
    b = _lerp(tex[:, r[0][:, None], q[1][None]], tex[:, r[1][:, None], q[1][None]], r[2][:, None])
    return _lerp(a, b, q[2][None])


def _emulate_display(dye, out_hw, shading, bloom, rays, dither, compose, direct=False):
    """display_kernel tile by tile in numpy: the staged form, or with
    ``direct`` the direct form, each tap's rows and columns read from the
    whole dye."""
    th, tw = kdisplay.TILE
    c_, h, w = dye.shape
    oh, ow = out_hw
    tx, ty, nz = (f32(v) for v in tdisplay.shading_constants(out_hw))
    win_h, win_w = kdisplay.window(h, w, oh, ow, shading)
    if not compose:
        bloom = rays = dither = None
    if bloom is None:
        dither = None
    out = np.full((c_ + 1 if compose else c_, oh, ow), np.nan, f32)
    lit = np.full((3, oh, ow), np.nan, f32)     # the bloom before its gamma
    for r0 in range(0, oh, th):
        for q0 in range(0, ow, tw):
            nr, nq = min(th, oh - r0), min(tw, ow - q0)
            rows = [_tables(h, oh, r0, th, o) for o in (0.0, ty, -ty)]
            cols = [_tables(w, ow, q0, tw, o) for o in (0.0, tx, -tx)]
            if direct:
                def col_then_row(t):
                    return np.stack([_sample(dye[k], t, cols[0]) for k in range(c_)])

                def row_then_col(t):
                    return _sample_rows_cols(dye, rows[0], t)
            else:
                lo, hi = (2, 1) if shading else (0, 0)
                oy, ox = rows[lo][0][0], cols[lo][0][0]
                wh, ww = rows[hi][1][nr - 1] - oy + 1, cols[hi][1][nq - 1] - ox + 1
                assert wh <= win_h and ww <= win_w
                win = dye[:, oy:oy + wh, ox:ox + ww].astype(f32)
                assert win.shape == (c_, wh, ww)
                c0 = cols[0]
                hc = _lerp(win[:, :, c0[0] - ox], win[:, :, c0[1] - ox], c0[2])    # (C, wh, tw)
                r_ = rows[0]
                vr = _lerp(win[:, r_[0] - oy, :], win[:, r_[1] - oy, :],
                           r_[2][:, None])                                       # (C, th, ww)

                def col_then_row(t, hc=hc, oy=oy):
                    return _lerp(hc[:, t[0] - oy, :], hc[:, t[1] - oy, :], t[2][:, None])

                def row_then_col(t, vr=vr, ox=ox):
                    return _lerp(vr[:, :, t[0] - ox], vr[:, :, t[1] - ox], t[2])

            if not shading:
                res = col_then_row(rows[0])
            else:
                res = row_then_col(cols[0])
                taps = [row_then_col(cols[2]), row_then_col(cols[1]), col_then_row(rows[1]),
                        col_then_row(rows[2])]
                nl, nr_, nt, nb = (sum((x[k] * x[k] for k in range(1, c_)), x[0] * x[0])
                                   for x in taps)
                dx = _sqrt(nr_) - _sqrt(nl)
                dy = _sqrt(nt) - _sqrt(nb)
                inv_len = f32(1) / _sqrt(dx * dx + dy * dy + nz * nz)
                res = res * np.clip(nz * inv_len + f32(0.7), f32(0.7), f32(1))
            if compose:
                bl = None
                if bloom is not None:
                    rt, ct = _tables(bloom.shape[1], oh, r0, th, 0.0), _tables(
                        bloom.shape[2], ow, q0, tw, 0.0)
                    bl = np.stack([_sample(bloom[k], rt, ct) for k in range(3)])
                if rays is not None:
                    rt, ct = _tables(rays.shape[0], oh, r0, th, 0.0), _tables(
                        rays.shape[1], ow, q0, tw, 0.0)
                    s = _sample(rays, rt, ct)
                    res = res * s
                    if bl is not None:
                        bl = bl * s
                if bl is not None:
                    if dither is not None:
                        dh, dw = dither.shape
                        rt = _tables(dh, oh, r0, th, 0.0, f32(oh / dh), True)
                        ct = _tables(dw, ow, q0, tw, 0.0, f32(ow / dw), True)
                        noise = _sample(dither, rt, ct)
                        bl = bl + (noise * f32(2) - f32(1)) / f32(255)
                    lit[:, r0:r0 + nr, q0:q0 + nq] = bl[:, :nr, :nq]
            out[:c_, r0:r0 + nr, q0:q0 + nq] = res[:, :nr, :nq]
    if compose:
        # powf from the plain version's library, called over the whole
        # frame as the plain version calls it: PyTorch's CPU pow rounds by
        # the position in its vector loop.
        if bloom is not None:
            out[:3] = out[:3] + tdisplay.linear_to_gamma(torch.from_numpy(lit)).numpy()
        out[c_] = out[:c_].max(axis=0)
    return out


def _display_inputs(rng, h=40, w=70):
    dye = (rng.random((3, h, w)) * 1.5).astype(f32)
    bloom = (rng.random((3, 9, 17)) * 1.5).astype(f32)
    rays = rng.random((11, 19)).astype(f32)
    dither = rng.random((64, 64)).astype(f32)
    return dye, bloom, rays, dither


# (shading, bloom, sunrays, dither, compose), the render's variants
DISPLAY_VARIANTS = [(True, True, True, True, True), (False, True, True, True, True),
                    (True, False, True, False, True), (True, True, False, True, True),
                    (True, True, True, False, True), (True, None, None, None, False),
                    (False, None, None, None, False)]


@pytest.mark.parametrize("variant", DISPLAY_VARIANTS,
                         ids=lambda v: "".join("x-"[not b] if b is not None else "." for b in v))
@pytest.mark.parametrize("out_hw", [(37, 100), (50, 128), (16, 64), (80, 37)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=lambda d: str(d)[6:])
def test_display_kernel_structure_equals_plain(variant, out_hw, dtype):
    """The kernel's tiles, tables, window and shared stages, transliterated,
    give display_plain's bits: downsampled, upsampled, one whole tile, a
    width that fills no tile, each storage type of the dye."""
    shading, bl, sr, di, compose = variant
    rng = np.random.default_rng(out_hw[0] * 1000 + out_hw[1])
    dye, bloom, rays, dither = _display_inputs(rng)
    dye = torch.from_numpy(dye).to(dtype)
    pick = {True: torch.from_numpy, False: lambda a: None, None: lambda a: None}
    args = (pick[bl](bloom), pick[sr](rays), pick[di](dither))
    want = kdisplay.display_plain(dye, out_hw, shading, *args, compose=compose).numpy()
    got = _emulate_display(dye.float().numpy(), out_hw, shading,
                           *(None if a is None else a.numpy() for a in args), compose)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", DISPLAY_VARIANTS,
                         ids=lambda v: "".join("x-"[not b] if b is not None else "." for b in v))
@pytest.mark.parametrize("out_hw", [(64, 114), (16, 28)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=lambda d: str(d)[6:])
def test_display_direct_form_equals_plain(variant, out_hw, dtype):
    """The direct form, transliterated, gives display_plain's bits: a
    256x455 dye shown 4x and 16x smaller, the render's variants, each
    storage type of the dye."""
    shading, bl, sr, di, compose = variant
    rng = np.random.default_rng(out_hw[0] * 1000 + out_hw[1] + 7)
    dye, bloom, rays, dither = _display_inputs(rng, 256, 455)
    dye = torch.from_numpy(dye).to(dtype)
    pick = {True: torch.from_numpy, False: lambda a: None, None: lambda a: None}
    args = (pick[bl](bloom), pick[sr](rays), pick[di](dither))
    want = kdisplay.display_plain(dye, out_hw, shading, *args, compose=compose).numpy()
    got = _emulate_display(dye.float().numpy(), out_hw, shading,
                           *(None if a is None else a.numpy() for a in args), compose,
                           direct=True)
    np.testing.assert_array_equal(got, want)


def _display_smem(c, win_h, win_w, shading, itemsize=4):
    """csrc/display.cu display_smem_bytes plus the static tap tables
    (2 x 3 x (kTileH + kTileW) entries of 12 bytes): the window in the dye's
    storage type, win_w + 1 columns rounded up to even, padded to 16 bytes;
    the float32 column stage at the tile's columns for every window row;
    with shading the float32 row stage at the tile's rows for every window
    column."""
    th, tw = kdisplay.TILE
    pitch = (win_w + 2) & ~1
    window = (c * win_h * pitch * itemsize + 15) // 16 * 16
    stages = 4 * c * win_h * tw + (4 * c * th * pitch if shading else 0)
    return window + stages + 12 * 6 * (th + tw)


def _full_shapes():
    demo = FluidConfig(CANVAS_WIDTH=1280, CANVAS_HEIGHT=720).validate()
    square = FluidConfig(DYE_RESOLUTION=1024, CANVAS_WIDTH=1024, CANVAS_HEIGHT=1024).validate()
    out = []
    for cfg in (demo, square):
        dw, dh = cfg.dye_size
        cw, ch = cfg.capture_size
        for hw in ((cfg.CANVAS_HEIGHT, cfg.CANVAS_WIDTH), (ch, cw), (360, 640)):
            out.append((dh, dw) + hw)
    return out


@pytest.mark.parametrize("shape", _full_shapes(), ids=lambda s: "{}x{}->{}x{}".format(*s))
@pytest.mark.parametrize("shading", [True, False])
def test_display_window_covers_every_tap(shape, shading):
    """At the render's full output sizes (the demo's 720x1280 from its
    1024x1820 dye and 1024x1024, their captures, the 360x640 tick): every
    corner a tile's dye taps read lies inside the window from its origin,
    the largest window is window()'s, and with the column and row stages
    of the render's 3 dye channels it fits a block."""
    h, w, oh, ow = shape
    th, tw = kdisplay.TILE
    tx, ty, _ = (f32(v) for v in tdisplay.shading_constants((oh, ow)))
    win_h, win_w = kdisplay.window(h, w, oh, ow, shading)
    offs = [(0.0,), (0.0, ty, -ty)][shading]

    def extent(n_in, n_out, t, offs):
        taps = [_axis(np.arange(n_out), n_in, n_out, off=o) for o in offs]
        most = 0
        for s in range(0, n_out, t):
            seg = slice(s, min(s + t, n_out))
            lo = min(int(tp[0][seg].min()) for tp in taps)
            hi = max(int(tp[1][seg].max()) for tp in taps)
            origin = min(int(tp[0][s]) for tp in taps)
            assert origin == lo
            most = max(most, hi - lo + 1)
        return most

    assert extent(h, oh, th, offs) == win_h
    assert extent(w, ow, tw, [o for o in (0.0, tx, -tx)][:len(offs)]) == win_w
    assert _display_smem(3, win_h, win_w, shading) <= MAX_SHARED


def test_display_form_picks_by_shape():
    """display.form against the H100's 232,448 bytes: the staged form at the
    render's full output sizes (the demo, 1024x1024, their captures, the
    360x640 tick), shaded or not, in float32 and 16 bits; the direct form at
    every small canvas of check.DIRECT_GEOMETRIES with shading, in its dtype;
    the staged form's bytes are this module's reckoning of display.cu's, and
    a limit a byte under them turns the form direct."""
    for h, w, oh, ow in _full_shapes():
        for shading in (True, False):
            for itemsize in (4, 2):
                win = kdisplay.window(h, w, oh, ow, shading)
                need = kdisplay.smem_bytes(3, *win, shading, itemsize)
                assert need == _display_smem(3, *win, shading, itemsize)
                assert kdisplay.form(3, h, w, oh, ow, shading, itemsize, MAX_SHARED) == "staged"
                assert kdisplay.form(3, h, w, oh, ow, shading, itemsize, need) == "staged"
                assert kdisplay.form(3, h, w, oh, ow, shading, itemsize, need - 1) == "direct"
    for label, (_, _, _, dtype) in check.DIRECT_GEOMETRIES.items():
        (h, w), (oh, ow) = check.direct_geometry(label)
        itemsize = torch.empty((), dtype=dtype).element_size()
        win = kdisplay.window(h, w, oh, ow, True)
        assert kdisplay.smem_bytes(3, *win, True, itemsize) > MAX_SHARED, label
        assert kdisplay.form(3, h, w, oh, ow, True, itemsize, MAX_SHARED) == "direct", label


def test_display_kernel_of_on_the_cpu():
    """A CPU dye launches no kernel: kernel_of names the staged display,
    as render_cases labels it there, and force takes only the two forms."""
    dye = torch.zeros((3, 512, 914))
    assert kdisplay.kernel_of(dye, (112, 200), True) == "display"
    with pytest.raises(ValueError, match="force must be one of"):
        kdisplay.display(dye, (112, 200), True, force="windowed")
