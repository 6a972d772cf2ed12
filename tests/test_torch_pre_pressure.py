"""The fused pre-pressure kernel (csrc/stencil.cu pre_pressure_kernel).

On the CPU: a numpy transliteration of the kernel's tiles in float32,
without fused multiply-adds, held bit for bit against pre_pressure_plain in
float32, bfloat16 and float16, with and without splats, on every tile of
ops/cuda/stencil.TILES, on grids smaller than one tile and with ragged
edge tiles. Each block's shared-memory buffers start as NaN and a stage
writes only the texels inside the grid, so a read of a texel that the
kernel never writes shows in the outputs; every neighbour index is
checked to lie inside its buffer.

  stage 0  the velocity window (tile + 3 rows; tile +/- one 16-byte unit
           of columns) in storage type, the row factors gy * amt (rows
           padded to 4) and column factors gx of every splat row, and the
           list of the rows whose amount is not zero
  stage 1  the bump on tile+3, summed over the listed rows in order,
           rounded to storage
  stage 2  the curl on tile+2, float32
  stage 3  the confined, clamped velocity on tile+1, in place
  stage 4  the tile's velocity and divergence (-C walls), rounded once

The model also runs the kernel's true-wall form: a window of a larger
array, each read and write at the window's base plus a window row times the
array's pitch, the splat factors at the window's rows and columns, held to
the plain version with the same bounds inside the window.

On the card (skipped without one): the kernel on every tile against its
plain version bit for bit, its launches, and a refused launch.
"""

import numpy as np
import pytest
import torch

from tpufluid_torch.ops.cuda import build, dispatch
from tpufluid_torch.ops.cuda import stencil as kstencil
from tpufluid_torch.ops.splat import splat_factors

f32 = np.float32
HALO = kstencil.HALO
CS, DT = 30.0, 1.0 / 60.0
GRIDS = [(8, 8), (37, 53), (128, 228)]
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _inputs(h, w, dtype, splats: bool, device="cpu", seed=0):
    """Velocity N(0, 400) clipped to +/-1000 in ``dtype`` and, with
    ``splats``, the factors of 8 random splat rows, rows 2 and 7 inactive."""
    rng = np.random.default_rng(seed)
    vel = np.clip(rng.standard_normal((2, h, w)) * 400, -1000, 1000).astype(f32)
    vel = torch.from_numpy(vel).to(device=device, dtype=dtype)
    if not splats:
        return vel, None
    s = np.zeros((8, 8), f32)
    s[:, 0:2] = rng.random((8, 2))
    s[:, 2:4] = (rng.random((8, 2)) - 0.5) * 1000
    s[:, 7] = 1.0
    s[[2, 7], 7] = 0.0
    return vel, splat_factors(torch.from_numpy(s).to(device), h, w, 0.0025, w / h,
                              slice(2, 4))


def _round(x, dtype):
    """float32 values through storage ``dtype`` (round to nearest even)."""
    if dtype == torch.float32:
        return x
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).float().numpy()


def _sqrt(x):
    """sqrt from the plain version's library: PyTorch's CPU sqrt is not
    always numpy's correctly rounded one (the kernel's sqrtf is held to
    PyTorch's CUDA sqrt on the card)."""
    return torch.sqrt(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def _inside(g, n):
    return (g >= 0) & (g < n)


class _Buffer:
    """One shared-memory buffer of a block: NaN until written, read and
    written at global coordinates less its origin, each index checked."""

    def __init__(self, shape, origin):
        self.a = np.full(shape, np.nan, f32)
        self.origin = origin

    def at(self, i, j):
        y, x = i - self.origin[0], j - self.origin[1]
        assert y.min() >= 0 and y.max() < self.a.shape[-2], "row outside the buffer"
        assert x.min() >= 0 and x.max() < self.a.shape[-1], "column outside the buffer"
        return y, x


def _ring(ti0, tj0, th, tw, k, h, w):
    """Global (rows, columns) of the texels of tile+k inside the grid."""
    gi, gj = np.meshgrid(ti0 - k + np.arange(th + 2 * k), tj0 - k + np.arange(tw + 2 * k),
                         indexing="ij")
    m = _inside(gi, h) & _inside(gj, w)
    return gi[m], gj[m]


def _emulate_tile(vel, factors, out, div, ti0, tj0, tile, dtype, window):
    """One block: ``vel`` and ``out`` (2, Hs * Ws), ``div`` (Hs * Ws) flat,
    addressed as the kernel addresses them; ``window`` (r0w, c0w, h, w)."""
    r0w, c0w, h, w = window
    ws = factors[1].shape[1] if factors is not None else None
    pitch = div.pitch
    base = r0w * pitch + c0w
    th, tw = tile.th, tile.tw
    u_el = 16 // torch.empty((), dtype=dtype).element_size()
    wh, ww = th + 2 * HALO, tw + 2 * HALO
    whp = -(-wh // 4) * 4
    r0, c0 = ti0 - HALO, tj0 - HALO
    moving = [] if factors is None else [
        s for s in range(factors[2].shape[0]) if factors[2][s, 0] != 0 or factors[2][s, 1] != 0]

    # stage 0: the window's texels inside the grid, and the factors
    win = _Buffer((2, wh, tw + 2 * u_el), (r0, tj0 - u_el))
    rows, cols = r0 + np.arange(wh), tj0 - u_el + np.arange(tw + 2 * u_el)
    ri, ci = np.nonzero(_inside(rows, h))[0], np.nonzero(_inside(cols, w))[0]
    win.a[np.ix_([0, 1], ri, ci)] = vel[:, base + rows[ri][:, None] * pitch + cols[ci]]
    s_rows = 0 if factors is None else factors[2].shape[0]
    ga = np.full((2, s_rows, whp), np.nan, f32)
    gxs = np.full((s_rows, ww), np.nan, f32)
    wcols = c0 + np.arange(ww)
    wci = np.nonzero(_inside(wcols, w))[0]
    if s_rows:
        gy, gx, amt = factors
        assert gx.shape[1] == ws == pitch
        for c in range(2):
            ga[c][:, ri] = (gy[r0w + rows[ri]] * amt[:, c][None, :]).T
        gxs[:, wci] = gx[:, c0w + wcols[wci]]

    # stage 1: the bump on tile+3, rounded to storage
    bump = _Buffer((2, wh, ww), (r0, c0))
    gi, gj = _ring(ti0, tj0, th, tw, HALO, h, w)
    y, x = bump.at(gi, gj)
    wy, wx = win.at(gi, gj)
    u = win.a[:, wy, wx]
    if factors is not None:
        acc = np.zeros((2, gi.size), f32)
        for s in moving:
            acc = acc + ga[:, s, y] * gxs[s, x][None, :]
        u = _round(u + acc, dtype)
    bump.a[:, y, x] = u
    bu, bv = bump.a

    # stage 2: the curl on tile+2
    curl = _Buffer((th + 4, tw + 4), (ti0 - 2, tj0 - 2))
    gi, gj = _ring(ti0, tj0, th, tw, 2, h, w)
    v_r = bv[bump.at(gi, np.minimum(gj + 1, w - 1))]
    v_l = bv[bump.at(gi, np.maximum(gj - 1, 0))]
    u_t = bu[bump.at(np.minimum(gi + 1, h - 1), gj)]
    u_b = bu[bump.at(np.maximum(gi - 1, 0), gj)]
    curl.a[curl.at(gi, gj)] = f32(0.5) * (((v_r - v_l) - u_t) + u_b)

    # stage 3: the confined, clamped velocity on tile+1, in place
    gi, gj = _ring(ti0, tj0, th, tw, 1, h, w)
    c = curl.a[curl.at(gi, gj)]
    c_t = curl.a[curl.at(np.minimum(gi + 1, h - 1), gj)]
    c_b = curl.a[curl.at(np.maximum(gi - 1, 0), gj)]
    c_r = curl.a[curl.at(gi, np.minimum(gj + 1, w - 1))]
    c_l = curl.a[curl.at(gi, np.maximum(gj - 1, 0))]
    fx = f32(0.5) * (np.abs(c_t) - np.abs(c_b))
    fy = f32(0.5) * (np.abs(c_r) - np.abs(c_l))
    inv_len = f32(1.0) / (_sqrt(fx * fx + fy * fy) + f32(1e-4))
    scale = (f32(CS) * c) * inv_len
    fx = fx * scale
    fy = -(fy * scale)
    at = bump.at(gi, gj)
    bu[at] = np.minimum(np.maximum(bu[at] + fx * f32(DT), f32(-1000)), f32(1000))
    bv[at] = np.minimum(np.maximum(bv[at] + fy * f32(DT), f32(-1000)), f32(1000))

    # stage 4: the tile
    gi, gj = _ring(ti0, tj0, th, tw, 0, h, w)
    at = bump.at(gi, gj)
    u, v = bu[at], bv[at]
    lu = np.where(gj > 0, bu[bump.at(gi, np.maximum(gj - 1, 0))], -u)
    ru = np.where(gj < w - 1, bu[bump.at(gi, np.minimum(gj + 1, w - 1))], -u)
    bvv = np.where(gi > 0, bv[bump.at(np.maximum(gi - 1, 0), gj)], -v)
    tv = np.where(gi < h - 1, bv[bump.at(np.minimum(gi + 1, h - 1), gj)], -v)
    o = base + gi * pitch + gj
    out[0, o] = _round(u, dtype)
    out[1, o] = _round(v, dtype)
    div.a[o] = _round(f32(0.5) * (((ru - lu) + tv) - bvv), dtype)


class _Flat:
    """A flat plane and its row pitch."""

    def __init__(self, hs, ws):
        self.a = np.full(hs * ws, np.nan, f32)
        self.pitch = ws


def emulate(velocity, factors, tile, true_bounds=None):
    """The kernel on ``tile`` over every tile of the window of
    ``true_bounds`` (the whole grid without): (vel', div) as float32 numpy
    arrays of storage values, NaN where nothing was written."""
    dtype = velocity.dtype
    _, hs, ws = velocity.shape
    vel = velocity.float().numpy().reshape(2, hs * ws)
    fac = None if factors is None else tuple(t.numpy() for t in factors)
    window = kstencil.window(hs, ws, true_bounds)
    out = np.full((2, hs * ws), np.nan, f32)
    div = _Flat(hs, ws)
    for ti0 in range(0, window[2], tile.th):
        for tj0 in range(0, window[3], tile.tw):
            _emulate_tile(vel, fac, out, div, ti0, tj0, tile, dtype, window)
    return out.reshape(2, hs, ws), div.a.reshape(hs, ws)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("tile", kstencil.TILES, ids=lambda t: f"{t.th}x{t.tw}")
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("splats", [True, False], ids=["splats", "nosplats"])
def test_tile_structure_equals_plain(grid, tile, dtype, splats):
    vel, factors = _inputs(*grid, dtype, splats)
    want_v, want_d = kstencil.pre_pressure_plain(vel, CS, DT, factors)
    got_v, got_d = emulate(vel, factors, tile)
    np.testing.assert_array_equal(got_v, want_v.float().numpy())
    np.testing.assert_array_equal(got_d, want_d.float().numpy())


# The walls a shard of a 2x2 mesh of 37x53 blocks sees in its block padded
# by 16 rows and 64 columns (tpufluid_torch/parallel/sharded_step.py), and
# walls inside the first tile, on a tile edge and past the array.
BIG = 1 << 30
BOUNDS = {
    "top-left": (16, BIG, 64, BIG),
    "bottom-right": (-BIG, 16 + 36, -BIG, 64 + 52),
    "one-shard": (16, 16 + 36, 64, 64 + 52),
    "sentinels": (-BIG, BIG, -BIG, BIG),
    "first-tile": (3, 60, 5, 170),
    "tile-edge": (8, 64, 32, 128),
}


@pytest.mark.parametrize("bounds", sorted(BOUNDS), ids=str)
@pytest.mark.parametrize("tile", kstencil.TILES, ids=lambda t: f"{t.th}x{t.tw}")
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_window_structure_equals_plain(bounds, tile, dtype):
    """The kernel's true-wall form: its tiles on the window of the bounds,
    read and written through the window's base and the array's pitch,
    equal the plain version inside the window, and write nothing outside
    (where the plain version writes NaN)."""
    vel, factors = _inputs(37 + 32, 53 + 128, dtype, True, seed=3)
    r0, c0, h, w = kstencil.window(69, 181, BOUNDS[bounds])
    want_v, want_d = kstencil.pre_pressure_plain(vel, CS, DT, factors, BOUNDS[bounds])
    got_v, got_d = emulate(vel, factors, tile, BOUNDS[bounds])
    rows, cols = slice(r0, r0 + h), slice(c0, c0 + w)
    np.testing.assert_array_equal(got_v[:, rows, cols], want_v[:, rows, cols].float().numpy())
    np.testing.assert_array_equal(got_d[rows, cols], want_d[rows, cols].float().numpy())
    inside = np.zeros((69, 181), bool)
    inside[rows, cols] = True
    assert np.isnan(got_v[:, ~inside]).all() and np.isnan(got_d[~inside]).all()
    assert torch.isnan(want_v.float()[:, torch.from_numpy(~inside)]).all()
    assert torch.isnan(want_d.float()[torch.from_numpy(~inside)]).all()


@pytest.mark.parametrize("grid,sms,tile,blocks", [
    ((128, 228), 132, (8, 32), 128),        # the demo: 32x64 tiles give 16 blocks
    ((1024, 1024), 132, (32, 64), 512),
    ((4096, 4096), 132, (32, 64), 8192),
    ((8, 8), 132, (8, 32), 1),
    ((352, 448), 132, (8, 32), 616),        # 32x64 tiles give 77 blocks
    ((352, 1024), 132, (32, 64), 176),
    ((256, 512), 16, (32, 64), 64),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_plan(grid, sms, tile, blocks):
    """The tile plan picks at each grid and its blocks: LARGE where it
    gives every SM a block, else SMALL."""
    t = kstencil.TILES[kstencil.plan(*grid, sms)]
    assert ((t.th, t.tw), t.blocks(*grid)) == (tile, blocks)


def test_tiles_hold_the_halo():
    """Every tile is whole 16-byte units of each storage type (the window
    loads by 16-byte copies) and wider than the halo; the larger tile has
    the smaller overcompute."""
    for t in kstencil.TILES:
        assert t.th % 2 == 0 and t.tw % 8 == 0 and min(t.th, t.tw) > HALO
    large, small = kstencil.TILES[kstencil.LARGE], kstencil.TILES[kstencil.SMALL]
    assert large.overcompute() == pytest.approx(38 * 70 / (32 * 64))
    assert small.overcompute() == pytest.approx(14 * 38 / (8 * 32))


@pytest.mark.parametrize("grid", [(1, 1), (3, 200), (100, 7), (37, 53), (65, 129)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("tile", kstencil.TILES, ids=lambda t: f"{t.th}x{t.tw}")
def test_clamped_neighbours_lie_in_the_window(grid, tile):
    """Every stage's clamped neighbour of every texel of its ring inside the
    grid lies inside the buffer it reads, on grids smaller than one tile,
    thinner than the halo and with ragged edge tiles (_Buffer.at checks
    each index; no output is left unwritten)."""
    vel, _ = _inputs(*grid, torch.float32, False)
    out, div = emulate(vel, None, tile)
    assert np.isfinite(out).all() and np.isfinite(div).all()


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    """The card; skips the test where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("grid", GRIDS + [(64, 256), (530, 1090)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("splats", [True, False], ids=["splats", "nosplats"])
def test_pre_pressure_kernel_matches_plain(grid, dtype, splats, cuda):
    """Every tile, one launch each, bit-equal to the plain version: widths
    whose rows are whole 16-byte units (the cp.async window) and widths
    that are not (plain loads), grids smaller than one tile."""
    vel, factors = _inputs(*grid, dtype, splats, device=cuda, seed=1)
    want = kstencil.pre_pressure_plain(vel, CS, DT, factors)
    for n, t in enumerate(kstencil.TILES):
        before = kstencil.PRE_PRESSURE.launches
        got = kstencil.run_tiles(vel, CS, DT, factors, n)
        torch.cuda.synchronize()
        assert kstencil.PRE_PRESSURE.launches == before + 1, t
        for g, w in zip(got, want):
            assert torch.equal(g, w), (t, float((g.float() - w.float()).abs().max()))


def test_pre_pressure_launches_once_a_call(cuda):
    vel, factors = _inputs(128, 228, torch.float32, True, device=cuda)
    build.reset_launches()
    for _ in range(3):
        dispatch.pre_pressure(vel, CS, DT, splat_factors=factors)
    torch.cuda.synchronize()
    assert {k: v.launches for k, v in build.KERNELS.items() if v.launches} == \
        {"pre_pressure": 3}


def test_refused_pre_pressure_launch_raises(cuda):
    """Splat factors too many for a block's shared memory: the launch is
    refused, raises, and leaves no error for the next launch."""
    vel, _ = _inputs(64, 64, torch.float32, False, device=cuda)
    s = 4096
    factors = (torch.zeros((64, s), device=cuda), torch.zeros((s, 64), device=cuda),
               torch.zeros((s, 2), device=cuda))
    with pytest.raises(RuntimeError, match="pre_pressure failed to launch"):
        kstencil.pre_pressure(vel, CS, DT, factors)
    got = kstencil.pre_pressure(vel, CS, DT)
    torch.cuda.synchronize()
    for g, w in zip(got, kstencil.pre_pressure_plain(vel, CS, DT)):
        assert torch.equal(g, w)
