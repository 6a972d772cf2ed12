"""The decompositions of the advect and Jacobi kernels (csrc/advect.cu,
csrc/jacobi.cu), held on the CPU against the port's plain versions and the
JAX package, with inputs made by numpy from a seed at small sizes.

  * Advection: the plain prepare (bump, round to storage, RGB9E5 word or
    storage quad) followed by the plain gather from the prepared source
    equals advect_plain bit for bit; the packed word equals
    tpufluid.ops.quant.rgb9e5_pack bit for bit; the whole decomposed
    advection stays within tests/test_torch_ops.py's tolerances of the JAX
    oracle (1e-5 of the scale in float32, 0.02 of it in 16-bit storage).
    The dye kernel's windowed design, emulated in plain torch (each tile's
    window of advect.dye_window_plan prepared alone, its texels gathered in
    window coordinates), equals advect_plain bit for bit in every form the
    kernel takes, every texel's corners inside its tile's window.
  * Jacobi: a solve cut into launches of K sweeps through float32 scratch
    equals one run of N sweeps bit for bit; a numpy transliteration of
    jacobi_chunk_kernel's tiles, halos and clamps equals
    jacobi_plain bit for bit, so the kernel's structure is held here and
    its bits on the card (tests/test_torch_kernels.py, chip_smoke.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufluid.ops import quant as jquant
from tpufluid.ops.advect import advect as jax_advect
from tpufluid.ops.pallas import dispatch as jdispatch
from tpufluid_torch.ops.advect import decay_factor
from tpufluid_torch.ops import splat as tsplat
from tpufluid_torch.ops.cuda import advect as kadvect
from tpufluid_torch.ops.cuda import build
from tpufluid_torch.ops.cuda import build as kbuild
from tpufluid_torch.ops.quant import rgb9e5_unpack
from tpufluid_torch.ops.sampling import true_div
from tpufluid_torch.ops.cuda import jacobi as kjacobi

H, W = 48, 72          # the tests' sim grid (sim 48, canvas 192x128)
HD, WD = 96, 144       # its dye grid
DT = np.float32(1 / 60)
RADIUS, ASPECT = 0.25 / 100 * 1.5, 1.5
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(DTYPES[dtype])


def _velocity(rng, scale=400.0, h=H, w=W):
    return np.clip(rng.standard_normal((2, h, w)) * scale, -1000, 1000).astype(np.float32)


def _splats(rng, n=4):
    s = np.zeros((n, 8), np.float32)
    s[:, 0:2] = rng.random((n, 2))
    s[:, 2:4] = (rng.random((n, 2)) - 0.5) * 1000
    s[:, 4:7] = rng.random((n, 3)) * 1.5
    s[:, 7] = [1, 1, 0, 1][:n]
    return s


# ---------------------------------------------------------------- advection

# (source grid, splat bump, quant, dtype); RGB9E5 applies to bfloat16 only.
CASES = [(g, b, None, d) for g in ("same", "cross") for b in (False, True)
         for d in ("float32", "bfloat16", "float16")]
CASES += [(g, b, "rgb9e5", "bfloat16") for g in ("same", "cross") for b in (False, True)]


def _advect_inputs(rng, grid, bump, dtype, vel_scale=400.0):
    h, w = (H, W) if grid == "same" else (HD, WD)
    vel = _velocity(rng, vel_scale)
    src = rng.random((3, h, w)).astype(np.float32) * 1.5
    factors = None
    if bump:
        factors = tsplat.splat_factors(torch.from_numpy(_splats(rng)), h, w, RADIUS, ASPECT,
                                       slice(4, 7))
    return vel, src, factors


@pytest.mark.parametrize("grid,bump,quant,dtype", CASES)
def test_prepare_then_gather_equals_advect_plain(grid, bump, quant, dtype, rng):
    """Prepared words or quads, then the gather from them: the very values
    and the very rounding of advect_plain, at any displacement (the far
    case moves the dye by up to 1000 / 60 sim texels, ~33 dye texels)."""
    for scale in (400.0, 1e4):
        vel, src, factors = _advect_inputs(rng, grid, bump, dtype, scale)
        v, s = _t(vel, dtype), _t(src, dtype)
        prepared = kadvect.prepare_plain(s, factors, quant)
        h, w = s.shape[-2:]
        if quant:
            assert prepared.dtype == torch.int32 and tuple(prepared.shape) == (h, w)
        else:
            assert prepared.dtype == s.dtype and tuple(prepared.shape) == (h, w, 4)
            assert not prepared[..., 3].any()
        got = kadvect.gather_plain(v, prepared, 3, float(DT), 1.0)
        want = kadvect.advect_plain(v, s, float(DT), 1.0, splat_factors=factors, quant=quant)
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


@pytest.mark.parametrize("channels", [1, 2])
def test_prepare_then_gather_fewer_channels(channels, rng):
    """The quads hold 1 or 2 channels and zeros: still advect_plain's bits."""
    vel, src, _ = _advect_inputs(rng, "same", False, "float32")
    factors = tsplat.splat_factors(torch.from_numpy(_splats(rng)), H, W, RADIUS, ASPECT,
                                   slice(2, 2 + channels))
    s = _t(src[:channels], "bfloat16")
    prepared = kadvect.prepare_plain(s, factors)
    got = kadvect.gather_plain(_t(vel, "bfloat16"), prepared, channels, float(DT), 0.2)
    want = kadvect.advect_plain(_t(vel, "bfloat16"), s, float(DT), 0.2, splat_factors=factors)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bump", [False, True])
def test_prepared_word_equals_jax_pack(bump, rng):
    """The prepare's RGB9E5 word is tpufluid.ops.quant.rgb9e5_pack's, bit
    for bit, of the bumped and bf16-rounded source, including the edges of
    the format (zero, negative, the largest value, past it)."""
    src = rng.random((3, HD, WD)).astype(np.float32) * 4.0
    src[:, 0, :7] = [[0.0, -0.5, 65408.0, 70000.0, 0.99951172, 1.0, 1e-30]] * 3
    src[1, 1, :] *= 1e-4
    s = _t(src, "bfloat16")
    factors = None
    if bump:
        factors = tsplat.splat_factors(torch.from_numpy(_splats(rng)), HD, WD, RADIUS,
                                       ASPECT, slice(4, 7))
    words = kadvect.prepare_plain(s, factors, "rgb9e5")
    bumped = s if factors is None else (s.float() + tsplat.splat_bump(*factors)).to(s.dtype)
    want = np.asarray(jquant.rgb9e5_pack(jnp.asarray(bumped.float().numpy())))
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)


@pytest.mark.parametrize("grid,bump,quant,dtype", CASES)
def test_prepared_advection_matches_jax(grid, bump, quant, dtype, rng):
    """The decomposed advection against the JAX oracle (bump added and
    rounded to storage, RGB9E5 round trip, jnp advect on the float32
    upcast), with tests/test_torch_ops.py's tolerances."""
    vel, src, factors = _advect_inputs(rng, grid, bump, dtype)
    h, w = src.shape[-2:]
    got = kadvect.gather_plain(_t(vel, dtype), kadvect.prepare_plain(_t(src, dtype), factors,
                                                                     quant), 3, float(DT), 1.0)
    jsrc = jnp.asarray(src).astype(dtype)
    if factors is not None:
        jsrc = jdispatch._apply_bump_rounded(jsrc, tuple(jnp.asarray(f.numpy())
                                                         for f in factors))
    jsrc = jsrc.astype(jnp.float32)
    if quant:
        jsrc = jquant.rgb9e5_roundtrip(jsrc)
    want = np.asarray(jax_advect(jnp.asarray(vel).astype(dtype).astype(jnp.float32), jsrc,
                                 DT, 1.0), np.float32)
    err = float(np.abs(got.float().numpy() - want).max())
    tol = (1e-5 if dtype == "float32" else 0.02) * float(np.abs(want).max())
    assert err <= tol, (err, tol)


def test_advect_kernels_refuse_cpu_tensors(rng):
    vel, src, factors = _advect_inputs(rng, "cross", True, "bfloat16")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kadvect.advect(_t(vel, "bfloat16"), _t(src, "bfloat16"), float(DT), 1.0, factors,
                       "rgb9e5")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kadvect.advect(_t(vel), _t(src, "bfloat16"), float(DT), 1.0, factors)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kadvect.advect(_t(vel, "bfloat16"), _t(vel, "bfloat16"), float(DT), 1.0)
    assert {"advect", "advect_dye"} <= set(build.KERNELS)
    assert "advect_prepare" not in build.KERNELS
    assert build.KERNELS["advect_dye"].replaces == build.KERNELS["advect"].replaces


def test_dye_velocity_types_are_checked(rng):
    """A dye call takes a velocity of the dye's storage type or, beside a
    16-bit dye, float32; the velocity's gather takes one type; both raise
    before any launch."""
    vel, src, factors = _advect_inputs(rng, "cross", True, "bfloat16")
    meta = torch.device("meta")
    v16, s16 = (torch.empty(t.shape, dtype=torch.bfloat16, device=meta) for t in (vel, src))
    with pytest.raises(ValueError, match="float32"):
        kadvect._check_dye_storage(v16.to(torch.float16), s16, packed=False)
    with pytest.raises(ValueError, match="float32"):
        kadvect._check_dye_storage(v16, s16.to(torch.float32), packed=False)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kadvect._check_dye_storage(v16.to(torch.float32), s16, packed=False)
    with pytest.raises(ValueError, match="mixed kernel inputs|expected a CUDA tensor"):
        kadvect._check_dye_storage(v16.to(torch.float32), s16, packed=True)
    # the plain version takes the float32 velocity as it is, no cast
    v32, s = _t(vel), _t(src, "bfloat16")
    got = kadvect.advect_plain(v32, s, float(DT), 1.0, factors, "rgb9e5")
    rounded = kadvect.advect_plain(v32.to(torch.bfloat16), s, float(DT), 1.0, factors,
                                   "rgb9e5")
    assert got.dtype == torch.bfloat16 and not torch.equal(got, rounded)


# ---------------------------------------------------------------- the dye's windows

def _smooth_velocity(h, w, scale=300.0):
    """A swirl: smooth across any tile, as a flow's velocity is."""
    y, x = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    return (np.stack([-y, x]) * scale * np.exp(-(x * x + y * y))).astype(np.float32)


def _windowed_sim(velocity, source, dt, dissipation, factors, quant):
    """advect_dye's design, one sim, in plain torch: per DYE_TILE tile,
    prepare_plain on its window alone (the source and the splat factors of
    the box's rows and columns), then each texel's 4 corners read in window
    coordinates, lerped in the plain order, divided by the decay, rounded
    once. Asserts that every corner lies in its tile's window."""
    plan = kadvect.dye_window_plan(velocity, source, dt, dissipation, factors, quant)
    c, h, w = source.shape
    r0, r1, q0, q1 = plan["corners"]
    fy, fx = plan["weights"]
    th, tw = kadvect.DYE_TILE
    decay = float(decay_factor(dissipation, dt))
    out = torch.empty((c, h, w), dtype=torch.float32)
    for ty, tx in np.ndindex(*plan["box"].shape[:2]):
        lo_r, hi_r, lo_q, hi_q = plan["box"][ty, tx].tolist()
        tile = (slice(ty * th, (ty + 1) * th), slice(tx * tw, (tx + 1) * tw))
        for r in (r0, r1):
            assert lo_r <= int(r[tile].min()) and int(r[tile].max()) <= hi_r
        for q in (q0, q1):
            assert lo_q <= int(q[tile].min()) and int(q[tile].max()) <= hi_q
        rows, cols = slice(lo_r, hi_r + 1), slice(lo_q, hi_q + 1)
        wf = None if factors is None else (factors[0][rows], factors[1][:, cols], factors[2])
        prep = kadvect.prepare_plain(source[:, rows, cols], wf, quant)
        vals = rgb9e5_unpack(prep) if quant else prep[..., :c].permute(2, 0, 1).float()

        def corner(r, q):
            return vals[:, r[tile] - lo_r, q[tile] - lo_q]

        a, b, cc, d = corner(r0, q0), corner(r0, q1), corner(r1, q0), corner(r1, q1)
        top = a + (b - a) * fx[tile]
        bot = cc + (d - cc) * fx[tile]
        out[(slice(None),) + tile] = true_div(top + (bot - top) * fy[tile], decay)
    return out.to(source.dtype), plan


def _windowed(velocity, source, dt, dissipation, factors=None, quant=None, sim_w=None):
    """_windowed_sim over a batch (dt a number or a (B, 2) table) or a
    packed fleet; also the plan's share of tiles that fit."""
    if sim_w is not None:
        b = source.shape[-1] // sim_w
        out, share = _windowed(kbuild.unpack_fleet(velocity, b), kbuild.unpack_fleet(source, b),
                               dt, dissipation, factors, quant)
        return kbuild.pack_fleet(out), share
    if source.ndim == 3:
        out, plan = _windowed_sim(velocity, source, dt, dissipation, factors, quant)
        return out, plan["share"]
    outs, shares = [], []
    for k in range(source.shape[0]):
        d = float(dt[k, 0]) if isinstance(dt, torch.Tensor) else dt
        f = None if factors is None else tuple(t[k] for t in factors)
        out, plan = _windowed_sim(velocity[k], source[k], d, dissipation, f, quant)
        outs.append(out)
        shares.append(plan["share"])
    return torch.stack(outs), float(np.mean(shares))


DYE_CASES = [(g, b, q, d) for g, b, q, d in CASES if b or q]


@pytest.mark.parametrize("grid,bump,quant,dtype", DYE_CASES)
def test_windowed_dye_equals_advect_plain(grid, bump, quant, dtype, rng):
    """One sim, same grid and cross grid, f32, f16 and bf16 with and without
    RGB9E5: the windowed design gives advect_plain's bits, on a swirl (whose
    windows all fit) and on N(0, 400) noise (whose windows span up to 33
    texels more than the tile each way)."""
    vel, src, factors = _advect_inputs(rng, grid, bump, dtype)
    for v in (_smooth_velocity(H, W), vel):
        vt, s = _t(v, dtype), _t(src, dtype)
        got, share = _windowed(vt, s, float(DT), 1.0, factors, quant)
        want = kadvect.advect_plain(vt, s, float(DT), 1.0, splat_factors=factors, quant=quant)
        assert got.dtype == want.dtype and torch.equal(got, want)
        assert share == 1.0 or v is vel


@pytest.mark.parametrize("grid", ["same", "cross"])
def test_windowed_dye_with_a_float32_velocity(grid, rng):
    """A float32 velocity beside a bf16 RGB9E5 dye (the sharded step's):
    advect_plain's bits, the velocity never rounded to storage."""
    vel, src, factors = _advect_inputs(rng, grid, True, "bfloat16")
    for v in (_smooth_velocity(H, W), vel):
        vt, s = _t(v), _t(src, "bfloat16")
        got, _ = _windowed(vt, s, float(DT), 1.0, factors, "rgb9e5")
        assert torch.equal(got, kadvect.advect_plain(vt, s, float(DT), 1.0, factors, "rgb9e5"))


@pytest.mark.parametrize("dtype,quant", [("float32", None), ("bfloat16", "rgb9e5"),
                                         ("float16", None)])
def test_windowed_dye_batched_and_packed(dtype, quant, rng):
    """A batch of 3 cross-grid sims with a (B, 2) dt table, and a packed
    fleet of 3 same-grid sims at the lock-step dt: advect_plain's bits."""
    from tpufluid_torch.step import dt_table

    b = 3
    table = torch.from_numpy(dt_table(np.array([1 / 90, 1 / 75, 1 / 60], np.float32),
                                      [1.0])[0])
    vel = np.stack([_velocity(rng) for _ in range(b)])
    vel[1] = _smooth_velocity(H, W)
    src = rng.random((b, 3, HD, WD)).astype(np.float32) * 1.5
    splats = torch.from_numpy(np.stack([_splats(rng) for _ in range(b)]))
    factors = tsplat.splat_factors(splats, HD, WD, RADIUS, ASPECT, slice(4, 7))
    v, s = _t(vel, dtype), _t(src, dtype)
    got, _ = _windowed(v, s, table, 1.0, factors, quant)
    assert torch.equal(got, kadvect.advect_plain(v, s, table, 1.0, factors, quant))
    # packed: the sims side by side, each its own walls
    factors = tsplat.splat_factors(splats, H, W, RADIUS, ASPECT, slice(4, 7))
    v = kbuild.pack_fleet(_t(vel, dtype))
    s = kbuild.pack_fleet(_t(src[..., :H, :W], dtype))
    got, _ = _windowed(v, s, float(DT), 1.0, factors, quant, sim_w=W)
    want = kadvect.advect_plain(v, s, float(DT), 1.0, factors, quant, sim_w=W)
    assert torch.equal(got, want)


def test_dye_window_plan_counts_the_kernels_budget(rng):
    """The window's bytes as csrc/advect.cu counts them, and the plan's
    tiles: with no displacement, a 32 x 32 tile reads its own texels and at
    most one more each way (the backtrace's rounding can put a texel's
    floor one below it)."""
    assert kadvect.dye_window_bytes(17, 65, 3, 2, "rgb9e5", 8, 2) == 4 * 8 * 4 \
        + 4 * 2 * (17 * 3 + 65) + 17 * 65 * 4
    assert kadvect.dye_window_bytes(17, 65, 3, 4, None, 0, 0) == 17 * 65 * 12
    assert kadvect.DYE_TILE == (32, 32)
    still = torch.zeros((2, 40, 150))
    plan = kadvect.dye_window_plan(still, torch.zeros((3, 40, 150)), float(DT), 1.0)
    assert tuple(plan["box"].shape) == (2, 5, 4) and plan["share"] == 1.0
    for ty, tx in np.ndindex(2, 5):
        r0, r1, q0, q1 = plan["box"][ty, tx].tolist()
        assert 32 * ty - 1 <= r0 <= 32 * ty and min(32 * ty + 31, 39) <= r1 <= 32 * ty + 32
        assert 32 * tx - 1 <= q0 <= 32 * tx and min(32 * tx + 31, 149) <= q1 <= 32 * tx + 32
    assert plan["box"][1, 4].tolist()[1::2] == [39, 149]     # the ragged corner, clamped
    # windows past the budget: +/-1000 texels a second of noise in f32
    # reach 17 texels beyond the tile, 66 x 66 texels of 12 bytes; the
    # narrow tile at the grid's right edge clamps its window
    plan = kadvect.dye_window_plan(_t(_velocity(rng, 1e4, HD, WD)),
                                   _t(rng.random((3, HD, WD))), float(DT), 1.0)
    assert not plan["fits"][1, 1:4].any() and plan["fits"][0, 4]


# ---------------------------------------------------------------- Jacobi

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("n,k", [(1, 4), (3, 4), (4, 4), (5, 4), (20, 4), (20, 5), (23, 10),
                                 (20, 20), (7, 1)])
def test_jacobi_chunks_equal_one_run(n, k, dtype, rng):
    p, d = rng.standard_normal((H, W)), rng.standard_normal((H, W))
    cut = kjacobi.chunks(n, k)
    assert sum(cut) == n and len(cut) == math.ceil(n / k) and max(cut) <= k
    got = kjacobi.jacobi_chunks_plain(_t(p, dtype), _t(d, dtype), cut, prescale=0.8)
    want = kjacobi.jacobi_plain(_t(p, dtype), _t(d, dtype), n, prescale=0.8)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_jacobi_chunks_match_jax(rng):
    """A cut solve against the JAX package's solve (float32, 20 sweeps,
    warm start 0.8), within test_torch_ops.py's 1e-6 of the scale."""
    p, d = rng.standard_normal((H, W)), rng.standard_normal((H, W))
    got = kjacobi.jacobi_chunks_plain(_t(p), _t(d), kjacobi.chunks(20, 10), prescale=0.8)
    want = np.asarray(jdispatch.jacobi_pressure(jnp.asarray(p, jnp.float32),
                                                jnp.asarray(d, jnp.float32), 20, prescale=0.8))
    assert float(np.abs(got.numpy() - want).max()) <= 1e-6 * float(np.abs(want).max())


def _emulate_chunk(p: np.ndarray, d: np.ndarray, k: int, tiles: int) -> np.ndarray:
    """One launch of jacobi_chunk_kernel in numpy float32, index for index:
    each block's region (tile and K-deep halo) loaded with clamped indices,
    k sweeps in which a grid cell's neighbours clamp at the grid's edge and
    every other read clamps into the region, then the central tile
    written."""
    t = kjacobi.TILES[tiles]
    h, w = p.shape
    rh, rw = t.rh, t.rw
    th, tw = rh - 2 * k, rw - 2 * k
    origins = [(by * th - k, bx * tw - k) for by in range(math.ceil(h / th))
               for bx in range(math.ceil(w / tw))]
    regions, loc = [], []
    for r0, c0 in origins:
        gi = np.arange(r0, r0 + rh)[:, None]
        gj = np.arange(c0, c0 + rw)[None, :]
        ci, cj = np.clip(gi, 0, h - 1), np.clip(gj, 0, w - 1)
        regions.append(p[ci, cj].copy())
        loc.append((gi, gj, d[ci, cj]))
    for _ in range(k):
        for b, ((r0, c0), (gi, gj, db)) in enumerate(zip(origins, loc)):
            c = regions[b]
            jl = np.clip(np.maximum(gj - 1, 0) - c0, 0, rw - 1)[0]
            jr = np.clip(np.minimum(gj + 1, w - 1) - c0, 0, rw - 1)[0]
            up = np.concatenate([c[1:], c[rh - 1:]])
            down = np.concatenate([c[:1], c[:-1]])
            t_ = np.where(gi + 1 < h, up, c)
            bb = np.where(gi > 0, down, c)
            regions[b] = ((((c[:, jl] + c[:, jr]) + t_) + bb) - db) * np.float32(0.25)
    out = np.full_like(p, np.nan)
    for (r0, c0), r in zip(origins, regions):
        tile = r[k:rh - k, k:rw - k]
        rows = slice(r0 + k, min(r0 + k + th, h))
        cols = slice(c0 + k, min(c0 + k + tw, w))
        out[rows, cols] = tile[:rows.stop - rows.start, :cols.stop - cols.start]
    return out


SHAPES = [(5, 7), (37, 37), (48, 72), (70, 150), (128, 228)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("tiles", range(len(kjacobi.TILES)))
def test_jacobi_kernel_structure_equals_plain(tiles, shape):
    """The kernel's tiles and halos, transliterated, give jacobi_plain's
    bits for several K, on grids smaller than one tile, not a multiple of
    it, and the demo's; every cell of the grid is written."""
    t = kjacobi.TILES[tiles]
    h, w = shape
    rng = np.random.default_rng(h * 1000 + w)
    p = rng.standard_normal((h, w), dtype=np.float32)
    d = rng.standard_normal((h, w), dtype=np.float32)
    p0 = p * np.float32(0.8)
    for n, k in ((3, 3), (7, 4), (11, 5), (20, 10), (20, t.max_sweeps())):
        got = p0
        for kk in kjacobi.chunks(n, k):
            got = _emulate_chunk(got, d, kk, tiles)
        want = kjacobi.jacobi_plain(torch.from_numpy(p), torch.from_numpy(d), n, 0.8).numpy()
        assert not np.isnan(got).any()
        np.testing.assert_array_equal(got, want)


def test_jacobi_plan():
    """On the H100 SXM's 132 SMs: 64x128 tiles where they give every SM a
    block (1024^2, 4096^2), 32x64 tiles on smaller grids (the demo's
    128x228, the ragged 37x66); ceil(N / K) launches of K sweeps, the last
    shorter; N = 0 none. The threshold follows the SM count."""
    k, sms = kjacobi.SWEEPS, 132
    for (h, w), tiles in (((1024, 1024), kjacobi.LARGE), ((4096, 4096), kjacobi.LARGE),
                          ((128, 228), kjacobi.SMALL), ((37, 66), kjacobi.SMALL)):
        for n in (1, k - 1, k, k + 1, 20, 23):
            got, cut = kjacobi.plan(h, w, n, sms)
            assert got == tiles and len(cut) == math.ceil(n / k) and sum(cut) == n
            assert max(cut) <= kjacobi.TILES[tiles].max_sweeps()
        assert kjacobi.plan(h, w, 0, sms) == (tiles, [])
        assert kjacobi.design_cell_sweeps(h, w, 20, sms) >= h * w * 20
    # 1024^2 at K = 10: 24 x 10 = 240 blocks of the large tiles
    assert kjacobi.TILES[kjacobi.LARGE].blocks(1024, 1024, k) == 240
    assert kjacobi.tiles_for(1024, 1024, 240) == kjacobi.LARGE
    assert kjacobi.tiles_for(1024, 1024, 241) == kjacobi.SMALL
    assert kjacobi.design_cell_sweeps(1024, 1024, 0, sms) == 0


def test_jacobi_wrapper_checks_its_cut(rng):
    p = _t(rng.standard_normal((H, W)))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kjacobi.jacobi_pressure(p, p, 20, 0.8)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kjacobi.run_chunks(p, p, 0.8, [10, 10])
    for tiles in (kjacobi.LARGE, kjacobi.SMALL):
        top = kjacobi.TILES[tiles].max_sweeps()
        kjacobi.check_cut(tiles, [top, 1])
        for cut in ([], [0], [top + 1], [10, top + 1]):
            with pytest.raises(ValueError, match="cannot run sweeps"):
                kjacobi.check_cut(tiles, cut)
    assert (kjacobi.TILES[kjacobi.LARGE].max_sweeps(), kjacobi.TILES[kjacobi.SMALL].max_sweeps()
            ) == (31, 15)
    assert "jacobi_chunk" in build.KERNELS and "jacobi_sweep" not in build.KERNELS


def test_ptxas_report_parses_the_compiler_log():
    log = """ptxas info    : Compiling entry function '_Z13advect_kernelIfLi2ELi0ELb1EEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _Z13advect_kernelIfLi2ELi0ELb1EEvPKT_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers, 400 bytes cmem[0]
ptxas info    : Function properties for _Z5otheri
    24 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 5760 bytes smem, 380 bytes cmem[0]
"""
    assert build.ptxas_report(log) == [
        {"function": "_Z13advect_kernelIfLi2ELi0ELb1EEvPKT_", "stack": 0, "spill_stores": 0,
         "spill_loads": 0, "registers": 30, "smem": 0},
        {"function": "_Z5otheri", "stack": 24, "spill_stores": 8, "spill_loads": 4,
         "registers": 255, "smem": 5760}]
