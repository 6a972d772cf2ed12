"""The structure of the sunrays kernels (csrc/sunrays.cu), held on the CPU:
a numpy transliteration in float32, without fused multiply-adds, of the
kernels' indexing and arithmetic, against ops/sunrays.apply_sunrays (their
plain version) bit for bit, with dyes made by numpy from a seed.

  * The plan tables of ops/cuda/sunrays.tables, read as the kernels read
    them: rows of (i0, i1, bits of 1 - f, bits of f), the march's column
    and row stages, then the blur's.
  * The march (sunrays_kernel): per band of 16 dye rows by 256 columns,
    the mask of the band and the next row and column formed once from the
    three channels (NaN kept as PyTorch's amax and clamp keep it), then
    for each of the 17 taps the rectangle of output texels that
    band_bounds gives the band, each from its 2 x 2 corners in the band
    (an index outside it raises): the column stage at both corner rows,
    the row stage, written to the (B, 17, h, w) scratch, every entry once.
  * The blur (sunrays_blur_kernel, 16x32 tiles): per tile the rays window
    with its halo of 3 (0 outside the grid), each texel the decay-weighted
    sum of its taps in tap order times the exposure, the column pass's three column
    stages at the tile's columns and one around for every window row, its
    identity row stage and weighted sum at the tile's rows and two around,
    the row pass's identity column stage at the tile's columns, its three
    row stages and weighted sum; each index taken relative to its window,
    so a tap outside the window raises.

Geometries: the fleet's (a 1820x1024 dye, 348x196 rays) at B = 2, an odd
canvas (333x201), a dye smaller than the sunrays grid (the taps upsample),
and weights other than 1. The kernels' bits on the card:
tests/test_torch_kernels.py, tests/test_torch_batch_render_kernels.py,
chip_smoke.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpufluid_torch import FluidConfig
from tpufluid_torch.ops import sunrays as tsunrays
from tpufluid_torch.ops.cuda import build, dispatch
from tpufluid_torch.ops.cuda import sunrays as ksunrays
from tpufluid_torch.ops.sampling import affine_axis_plan

f32 = np.float32
HALO = 3
TILE = (16, 32)     # csrc/sunrays.cu kTileH, kTileW
BAND = (16, 256)    # csrc/sunrays.cu kBandRows, kBandCols


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch intra-op thread for this module: the suite runs files in
    parallel workers, and each worker's full thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split_tables(tab: np.ndarray, h: int, w: int):
    """The tables' groups as (i0, i1, g, f) arrays of shape (stages, n):
    march columns, march rows, blur columns, blur rows."""
    taps = ksunrays.TAPS
    sizes = [(taps, w), (taps, h), (3, w), (3, h)]
    out, at = [], 0
    for stages, n in sizes:
        rows = tab[at:at + stages * n].reshape(stages, n, 4)
        out.append((rows[..., 0], rows[..., 1], rows[..., 2].view(f32), rows[..., 3].view(f32)))
        at += stages * n
    assert at == tab.shape[0]
    return out


def _split_bounds(bounds: np.ndarray, dh: int, dw: int):
    """band_bounds as (rows (17, row bands + 1), columns (17, column bands
    + 1))."""
    nr, nc = -(-dh // BAND[0]) + 1, -(-dw // BAND[1]) + 1
    taps = ksunrays.TAPS
    assert bounds.shape == (taps * (nr + nc),)
    return bounds[:taps * nr].reshape(taps, nr), bounds[taps * nr:].reshape(taps, nc)


def _max_nan(a, b):
    return np.where((a > b) | (a != a), a, b)


def _mask(dye):
    """mask_at over dye (3, ...) of one sim."""
    br = _max_nan(_max_nan(dye[0], dye[1]), dye[2])
    t = br * f32(20)
    t = np.where(t < f32(0), f32(0), t)
    t = np.where(t > f32(0.8), f32(0.8), t)
    return f32(1) - t


def _lerp(a, b, g, f):
    return a * g + b * f


def _march(dye, tabs, bounds, taps_out, written):
    """sunrays_kernel over one sim's bands: each tap's samples written to
    taps_out (17, h, w), each entry counted in ``written``."""
    (ci0, ci1, cg, cf), (ri0, ri1, rg, rf) = tabs[0], tabs[1]
    _, dh, dw = dye.shape
    row_bands, col_bands = bounds
    for j in range(row_bands.shape[1] - 1):
        r0 = j * BAND[0]
        for i in range(col_bands.shape[1] - 1):
            c0 = i * BAND[1]
            mask = _mask(dye[:, r0:r0 + BAND[0] + 1, c0:c0 + BAND[1] + 1])
            for k in range(ksunrays.TAPS):
                y = np.arange(row_bands[k, j], row_bands[k, j + 1])[:, None]
                x = np.arange(col_bands[k, i], col_bands[k, i + 1])[None, :]
                a = _window(ri0[k][y], r0, mask.shape[0])
                b = _window(ri1[k][y], r0, mask.shape[0])
                c = _window(ci0[k][x], c0, mask.shape[1])
                d = _window(ci1[k][x], c0, mask.shape[1])
                g, f = cg[k][x], cf[k][x]
                top = _lerp(mask[a, c], mask[a, d], g, f)
                bot = _lerp(mask[b, c], mask[b, d], g, f)
                taps_out[k, y, x] = _lerp(top, bot, rg[k][y], rf[k][y])
                written[k, y, x] += 1


def _rays(taps, decay):
    """rays_at over a sim's whole grid: tap 0, then + tap_k * decay_k in
    tap order, times the exposure."""
    color = taps[0]
    for k in range(1, ksunrays.TAPS):
        color = color + taps[k] * f32(decay[k])
    return color * f32(0.7)


def _window(a, lo, n):
    """Indices ``a`` relative to a window of n starting at ``lo``: raises
    for an index the window does not hold (the kernel's shared memory)."""
    rel = np.asarray(a) - lo
    assert rel.size == 0 or (rel.min() >= 0 and rel.max() < n), (rel.min(), rel.max(), n)
    return rel


def _blur_tile(rays_win, tabs, y0, x0, ty, tx, h, w):
    """sunrays_blur_kernel's tile at (y0, x0) of ty x tx, from its rays window
    (ty + 6, tx + 6): the tile's output, rows and columns past the grid cut."""
    (bc0, bc1, bcg, bcf), (br0, br1, brg, brf) = tabs[2], tabs[3]
    c_mid = np.arange(x0 - 1, x0 + tx + 1)            # the column pass's columns
    r_win = np.arange(y0 - HALO, y0 + ty + HALO)       # window rows
    r_mid = np.arange(y0 - 2, y0 + ty + 2)             # the column pass's rows
    cv = (c_mid >= 0) & (c_mid < w)
    wv = (r_win >= 0) & (r_win < h)
    mv = (r_mid >= 0) & (r_mid < h)
    cols = np.zeros((3, ty + 2 * HALO, tx + 2), f32)
    xs = c_mid[cv]
    for k in range(3):
        a = _window(bc0[k][xs], x0 - HALO, tx + 2 * HALO)
        b = _window(bc1[k][xs], x0 - HALO, tx + 2 * HALO)
        cols[k][np.ix_(wv, cv)] = _lerp(rays_win[wv][:, a], rays_win[wv][:, b],
                                        bcg[k][xs], bcf[k][xs])
    pass1 = np.zeros((ty + 4, tx + 2), f32)
    ys = r_mid[mv]
    a = _window(br0[0][ys], y0 - HALO, ty + 2 * HALO)
    b = _window(br1[0][ys], y0 - HALO, ty + 2 * HALO)
    g, f = brg[0][ys][:, None], brf[0][ys][:, None]
    center, minus, plus = (_lerp(cols[k][a][:, cv], cols[k][b][:, cv], g, f) for k in range(3))
    pass1[np.ix_(mv, cv)] = (center * f32(0.29411764) + minus * f32(0.35294117)) \
        + plus * f32(0.35294117)
    xt = np.arange(x0, min(x0 + tx, w))
    a = _window(bc0[0][xt], x0 - 1, tx + 2)
    b = _window(bc1[0][xt], x0 - 1, tx + 2)
    pass1_cols = np.zeros((ty + 4, xt.size), f32)
    pass1_cols[mv] = _lerp(pass1[mv][:, a], pass1[mv][:, b], bcg[0][xt], bcf[0][xt])
    yt = np.arange(y0, min(y0 + ty, h))
    taps = []
    for k in range(3):
        a = _window(br0[k][yt], y0 - 2, ty + 4)
        b = _window(br1[k][yt], y0 - 2, ty + 4)
        taps.append(_lerp(pass1_cols[a], pass1_cols[b], brg[k][yt][:, None], brf[k][yt][:, None]))
    return (taps[0] * f32(0.29411764) + taps[1] * f32(0.35294117)) + taps[2] * f32(0.35294117)


def _emulate(dye, out_hw, weight):
    """The march and the blur launches over a batch (B, 3, H, W) ->
    (B, h, w)."""
    nb, _, dh, dw = dye.shape
    h, w = out_hw
    tabs = _split_tables(ksunrays.tables((dh, dw), out_hw).numpy(), h, w)
    bounds = _split_bounds(ksunrays.band_bounds((dh, dw), out_hw).numpy(), dh, dw)
    decay = ksunrays.decay_weights(weight)
    ty, tx = TILE
    out = np.full((nb, h, w), np.nan, f32)
    for s in range(nb):
        taps = np.zeros((ksunrays.TAPS, h, w), f32)
        written = np.zeros(taps.shape, np.int64)
        _march(dye[s], tabs, bounds, taps, written)
        assert (written == 1).all()
        rays = _rays(taps, decay)
        padded = np.zeros((h + 2 * HALO + ty, w + 2 * HALO + tx), f32)
        padded[HALO:HALO + h, HALO:HALO + w] = rays
        for y0 in range(0, h, ty):
            for x0 in range(0, w, tx):
                win = padded[y0:y0 + ty + 2 * HALO, x0:x0 + tx + 2 * HALO]
                tile = _blur_tile(win, tabs, y0, x0, ty, tx, h, w)
                out[s, y0:y0 + tile.shape[0], x0:x0 + tile.shape[1]] = tile
    return out


def _geometry(canvas, dye_res=1024, rays_res=196):
    cfg = FluidConfig(DYE_RESOLUTION=dye_res, SUNRAYS_RESOLUTION=rays_res,
                      CANVAS_WIDTH=canvas[0], CANVAS_HEIGHT=canvas[1]).validate()
    (dw, dh), (sw, sh) = cfg.dye_size, cfg.sunrays_size
    return (dh, dw), (sh, sw)


# (label, canvas w x h, DYE_RESOLUTION, SUNRAYS_RESOLUTION, B, weight)
GEOMETRIES = [
    ("fleet", (1280, 720), 1024, 196, 2, 1.0),
    ("odd-333x201", (333, 201), 256, 196, 1, 1.0),
    ("upsampled", (333, 201), 64, 196, 2, 1.0),
    ("weight-0.7", (640, 360), 128, 96, 3, 0.7),
    ("weight-2.5-tiny", (37, 23), 16, 9, 2, 2.5),
]


def _dye(nb, dye_hw, seed):
    """Values around the mask's knees: 20 * max below 0, between, above 0.8."""
    rng = np.random.default_rng(seed)
    return (rng.random((nb, 3) + dye_hw) * 0.06 - 0.01).astype(f32)


@pytest.mark.parametrize("label,canvas,dye_res,rays_res,nb,weight", GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES])
def test_sunrays_kernel_structure_equals_plain(label, canvas, dye_res, rays_res, nb, weight):
    """The kernels' launches, transliterated, give apply_sunrays's bits for
    a batch; its sims each equal apply_sunrays on that sim alone."""
    dye_hw, out_hw = _geometry(canvas, dye_res, rays_res)
    if label == "upsampled":
        assert dye_hw[0] < out_hw[0] and dye_hw[1] < out_hw[1]
    dye = _dye(nb, dye_hw, seed=dye_res + nb)
    want = tsunrays.apply_sunrays(torch.from_numpy(dye), out_hw, weight).numpy()
    np.testing.assert_array_equal(_emulate(dye, out_hw, weight), want)
    one = tsunrays.apply_sunrays(torch.from_numpy(dye[-1]), out_hw, weight).numpy()
    np.testing.assert_array_equal(want[-1], one)


def test_sunrays_kernel_structure_keeps_nan_and_infinities():
    """A NaN in one channel makes every rays texel whose taps reach its
    mask texel NaN, as apply_sunrays does; an infinite or negative-zero
    channel clamps as the plain ops clamp it."""
    dye_hw, out_hw = (40, 70), (20, 35)
    dye = _dye(2, dye_hw, seed=3)
    dye[0, 1, 10, 20] = np.nan
    dye[0, 0, 30, 50] = np.inf
    dye[1, 2, 5, 5] = -np.inf
    dye[1, :, 20, 30] = -0.0
    want = tsunrays.apply_sunrays(torch.from_numpy(dye), out_hw, 1.0).numpy()
    assert np.isnan(want[0]).any() and not np.isnan(want[1]).any()
    np.testing.assert_array_equal(_emulate(dye, out_hw, 1.0), want)


@pytest.mark.parametrize("dye_hw,out_hw", [((1024, 1820), (196, 348)), ((201, 333), (70, 117)),
                                           ((36, 64), (196, 348)), ((3, 5), (1, 1))])
def test_sunrays_tables_are_the_plans(dye_hw, out_hw):
    """The cached tables hold each stage's affine_axis_plan, (i0, i1, 1 - f,
    f), in the kernels' order (the march's 17 maps on both axes, then the
    blur's center, minus and plus on both), and are built once a geometry."""
    (dh, dw), (h, w) = dye_hw, out_hw
    tab = ksunrays.tables(dye_hw, out_hw)
    assert tab.dtype == torch.int32 and tab.is_contiguous()
    assert ksunrays.tables(dye_hw, out_hw) is tab
    maps = ksunrays.march_maps()
    assert len(maps) == ksunrays.TAPS and maps[0] == (1.0, 0.0)
    want = [(dw, w, s, o) for s, o in maps] + [(dh, h, s, o) for s, o in maps]
    want += [(w, w, 1.0, o) for o in ksunrays.blur_offsets(w)]
    want += [(h, h, 1.0, o) for o in ksunrays.blur_offsets(h)]
    at = 0
    for n_in, n_out, scale, off in want:
        i0, i1, f = affine_axis_plan(n_in, n_out, scale, off)
        rows = tab[at:at + n_out]
        assert torch.equal(rows[:, 0].long(), i0) and torch.equal(rows[:, 1].long(), i1)
        assert torch.equal(rows[:, 2].view(torch.float32), 1 - f)
        assert torch.equal(rows[:, 3].view(torch.float32), f)
        at += n_out
    assert at == tab.shape[0]


@pytest.mark.parametrize("dye_hw,out_hw", [((1024, 1820), (196, 348)), ((201, 333), (70, 117)),
                                           ((36, 64), (196, 348)), ((17, 257), (30, 500))])
def test_sunrays_band_bounds_split_every_tap(dye_hw, out_hw):
    """Each tap's bounds start at 0, end at the output size and rise; band
    j of each tap holds exactly the output indices whose first corner lies
    in dye rows (columns) 16 j .. 16 j + 15 (256 i .. 256 i + 255)."""
    (dh, dw), (h, w) = dye_hw, out_hw
    got = ksunrays.band_bounds(dye_hw, out_hw)
    assert got.dtype == torch.int32 and ksunrays.band_bounds(dye_hw, out_hw) is got
    rows, cols = _split_bounds(got.numpy(), dh, dw)
    for bounds, n_in, n_out, band, maps in ((rows, dh, h, BAND[0], 1), (cols, dw, w, BAND[1], 0)):
        assert (bounds[:, 0] == 0).all() and (bounds[:, -1] == n_out).all()
        assert (np.diff(bounds, axis=1) >= 0).all()
        for k, (scale, off) in enumerate(ksunrays.march_maps()):
            first = affine_axis_plan(n_in, n_out, scale, off)[0].numpy()
            band_of = np.repeat(np.arange(bounds.shape[1] - 1), np.diff(bounds[k]))
            np.testing.assert_array_equal(band_of, first // band)


def test_sunrays_decay_weights_are_the_march_sums():
    """decay_weights are the float32 of the march's Python doubles
    (decay * weight, decay multiplied by 0.95 a tap)."""
    for weight in (1.0, 0.7, 2.5):
        got = ksunrays.decay_weights(weight)
        decay, want = 1.0, [0.0]
        for _ in range(16):
            want.append(float(f32(decay * weight)))
            decay *= 0.95
        assert got == want
        assert list(ksunrays._decay(weight)) == want


@pytest.mark.parametrize("n", [1, 2, 3, 5, 17, 96, 196, 348, 1000, 4096])
def test_sunrays_halo_holds_every_blur_tap(n):
    """Every blur tap lies within 2 texels of its output index and every
    identity stage within 1 at any size, so the kernel's halo of 3 holds
    both passes (tables raises otherwise)."""
    for off, reach in zip(ksunrays.blur_offsets(n), (1, 2, 2)):
        i0, i1, _ = affine_axis_plan(n, n, 1.0, off)
        k = torch.arange(n)
        assert int(torch.maximum((i0 - k).abs(), (i1 - k).abs()).max()) <= reach
    ksunrays.tables((n, n), (n, n))


def test_sunrays_cases_are_the_renders_call():
    """sunrays_cases hold the frame's sunrays call: the float32 dye, the
    config's grid and weight, whose plain version gives the rays the
    display case reads; the dye read once and the rays written; a batch's
    case one call with B times one sim's work; none without sunrays."""
    from tpufluid_torch import stack_states
    from tpufluid_torch.ops.cuda import check

    cfg = FluidConfig(SIM_RESOLUTION=16, DYE_RESOLUTION=48, CANVAS_WIDTH=96, CANVAS_HEIGHT=64,
                      MAX_SPLATS=4, DTYPE="bfloat16").validate()
    state, _ = check.random_state(cfg, seed=3, device="cpu")
    (case,) = check.sunrays_cases(state, cfg)
    dye, rays_hw, weight = case.args
    assert case.label == case.kernel_name == "sunrays" and case.kernel is ksunrays.sunrays
    assert dye.dtype == torch.float32 and torch.equal(dye, state.dye.float())
    assert rays_hw == cfg.sunrays_size[::-1] and weight == cfg.SUNRAYS_WEIGHT
    display = check.render_cases(state, cfg)[-1]
    assert torch.equal(case.run(plain=True), display.args[4])
    sh, sw = rays_hw
    assert case.nbytes == dye.numel() * 4 + sh * sw * 4 and case.flops > 0
    batch = stack_states([state, state, state])
    (batched,) = check.sunrays_cases(batch, cfg, ":b3")
    assert batched.label == "sunrays:b3" and batched.args[0].shape[0] == 3
    assert (batched.nbytes, batched.flops) == (3 * case.nbytes, 3 * case.flops)
    assert torch.equal(batched.run(plain=True)[1], case.run(plain=True))
    assert check.sunrays_cases(state, dataclasses.replace(cfg, SUNRAYS=False)) == []


def test_routed_sunrays_on_the_cpu_runs_the_plain_ops():
    """ROUTED_RENDER.sunrays on a CPU dye is apply_sunrays and launches no
    kernel; PLAIN_RENDER.sunrays is apply_sunrays itself; the kernel's
    wrapper refuses a CPU or misshapen dye."""
    assert dispatch.PLAIN_RENDER.sunrays is tsunrays.apply_sunrays
    dye = torch.from_numpy(_dye(2, (30, 50), seed=5))
    build.reset_launches()
    got = dispatch.ROUTED_RENDER.sunrays(dye, (12, 20), 0.8)
    assert torch.equal(got, tsunrays.apply_sunrays(dye, (12, 20), 0.8))
    assert torch.equal(got[1], dispatch.ROUTED_RENDER.sunrays(dye[1], (12, 20), 0.8))
    assert not any(k.launches for k in build.KERNELS.values())
    with pytest.raises(ValueError, match="CUDA"):
        ksunrays.sunrays(dye, (12, 20), 0.8)
    with pytest.raises(ValueError, match="sunrays dye"):
        ksunrays.sunrays(dye[:, :2], (12, 20), 0.8)
    assert not any(k.launches for k in build.KERNELS.values())
    assert {"sunrays", "sunrays_blur"} <= set(build.KERNELS)
    assert "sunrays" in build.SOURCES
