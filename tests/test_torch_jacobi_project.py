"""The step's Jacobi solve with the gradient subtract fused into its last
launch (csrc/jacobi.cu jacobi_project_kernel, ops/cuda/jacobi.py
jacobi_project), held on the CPU with inputs made by numpy from a seed.

  * A numpy transliteration of the two kernels' index arithmetic (each
    block's region, its halo, the clamps, the batched and packed strides;
    the fused launch's halo one cell deeper, the rounding of the pressure
    to storage before the gradient reads its tile and ring) equals
    jacobi_plain then gradient_subtract_plain bit for bit, in every storage
    type, on both tiles, batched and packed, from no sweep to several
    launches' worth; every texel is written.
  * jacobi_project_plain stays within tests/test_torch_ops.py's tolerances
    of the JAX package's solve and gradient subtract (tpufluid.ops.stencil).
  * plan and check_cut with the fused launch's deeper halo.

The kernel's own bits are held on the card (tests/test_torch_kernels.py,
chip_smoke.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufluid.ops import stencil as jstencil
from tpufluid_torch.ops.cuda import build, jacobi as kjacobi
from tpufluid_torch.ops.cuda.build import pack_fleet

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
SHAPES = [(5, 7), (37, 37), (48, 72), (70, 150), (128, 228)]
SWEEPS = (0, 1, 10, 11, 20, 23)
PRESCALE = np.float32(0.8)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tests run in parallel workers, and each
    worker's full thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _round(x: np.ndarray, dtype) -> np.ndarray:
    """float32 values rounded to storage ``dtype`` and back, through torch."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).to(torch.float32).numpy()


def _emulate_launch(p, d, k, tiles, b, h, w, packed, prescale=np.float32(1.0), vel=None,
                    dtype=None):
    """One launch of jacobi_chunk_kernel, or with ``vel`` of
    jacobi_project_kernel, on flat float32 buffers of ``b`` sims of (h, w)
    (batched: sim z's pressure at z*h*w + i*w + j, its velocity at
    z*2*h*w + c*h*w + i*w + j; packed: at i*b*w + z*w + j, plane c a
    h*b*w apart), index for index: each block's region loaded with clamped
    indices and scaled by ``prescale``, k sweeps in which a grid cell's
    neighbours clamp at the grid's edge and every other read clamps into
    the region; the tile written, as it stands (float32 scratch) or, fused,
    rounded to ``dtype`` with the projected velocity. Returns the pressure
    (NaN where no block wrote) and, fused, the velocity."""
    t = kjacobi.TILES[tiles]
    rh, rw = t.rh, t.rw
    g = k + (vel is not None)
    th, tw = t.tile(k, vel is not None)
    z = np.arange(b)[:, None, None, None, None]
    r0 = (np.arange(-(-h // th)) * th - g)[None, :, None, None, None]
    c0 = (np.arange(-(-w // tw)) * tw - g)[None, None, :, None, None]
    lr = np.arange(rh)[None, None, None, :, None]
    tx = np.arange(rw)[None, None, None, None, :]
    gi, gj = r0 + lr, c0 + tx
    pitch, base = (b * w, z * w) if packed else (w, z * h * w)
    load = np.clip(gi, 0, h - 1) * pitch + base + np.clip(gj, 0, w - 1)
    v = p[load] * prescale
    dv = d[load]
    full = v.shape
    jl = np.broadcast_to(np.clip(np.maximum(gj - 1, 0) - c0, 0, rw - 1), full)
    jr = np.broadcast_to(np.clip(np.minimum(gj + 1, w - 1) - c0, 0, rw - 1), full)

    def up(c):      # the row below (i + 1); the region's last row reads itself
        return np.concatenate([c[..., 1:, :], c[..., -1:, :]], axis=3)

    def down(c):    # the row above (i - 1); the region's first row reads itself
        return np.concatenate([c[..., :1, :], c[..., :-1, :]], axis=3)

    for _ in range(k):
        c = v
        side = np.take_along_axis(c, jl, axis=4) + np.take_along_axis(c, jr, axis=4)
        v = (((side + np.where(gi + 1 < h, up(c), c)) + np.where(gi > 0, down(c), c))
             - dv) * np.float32(0.25)
    tile = (lr >= g) & (lr < rh - g) & (tx >= g) & (tx < rw - g) & (gi < h) & (gj < w)
    tile = np.broadcast_to(tile, full)
    at = np.broadcast_to(gi * pitch + base + gj, full)[tile]
    out = np.full(b * h * w, np.nan, np.float32)
    if vel is None:
        out[at] = v[tile]
        return out
    v = _round(v, dtype)
    out[at] = v[tile]
    pl, pr = np.take_along_axis(v, jl, axis=4)[tile], np.take_along_axis(v, jr, axis=4)[tile]
    pb = np.where(gi > 0, down(v), v)[tile]
    pt = np.where(gi + 1 < h, up(v), v)[tile]
    plane = h * b * w if packed else h * w
    v0 = at if packed else at + np.broadcast_to(z * h * w, full)[tile]
    vout = np.full(2 * b * h * w, np.nan, np.float32)
    vout[v0] = _round(vel[v0] - (pr - pl), dtype)
    vout[v0 + plane] = _round(vel[v0 + plane] - (pt - pb), dtype)
    return out, vout


def _emulate_project(p, d, vel, n, tiles, b, h, w, packed, dtype):
    """jacobi_project's launches: the chunks of SWEEPS through float32
    scratch, then the fused one (of no sweep for n = 0)."""
    cut = kjacobi.plan(h, w, n, 1, project=True)[1]
    src, scale = p, PRESCALE
    for k in cut[:-1]:
        src, scale = _emulate_launch(src, d, k, tiles, b, h, w, packed, scale), np.float32(1.0)
    return _emulate_launch(src, d, cut[-1], tiles, b, h, w, packed, scale, vel, dtype)


def _fields(rng, b, h, w, dtype):
    """(pressure (b, h, w), divergence, velocity (b, 2, h, w)) in storage."""
    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dtype)

    vel = np.clip(rng.standard_normal((b, 2, h, w)) * 400, -1000, 1000)
    return (t(rng.standard_normal((b, h, w))), t(rng.standard_normal((b, h, w))), t(vel))


def _flat(x: torch.Tensor) -> np.ndarray:
    return x.to(torch.float32).numpy().reshape(-1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("tiles", range(len(kjacobi.TILES)))
def test_fused_launch_structure_equals_plain_pair(tiles, shape, dtype):
    """The fused solve's launches, transliterated, give jacobi_plain's and
    gradient_subtract_plain's bits for a batch of 2 sims and for the same
    sims packed, at every sweep count of SWEEPS (0 and 1: the fused launch
    alone; 23: two chunks, then 3 fused sweeps), on grids smaller than a
    tile, not a multiple of it, and the demo's; every texel is written."""
    h, w = shape
    b, dt = 2, DTYPES[dtype]
    rng = np.random.default_rng(h * 1000 + w)
    p, d, vel = _fields(rng, b, h, w, dt)
    packs = (pack_fleet(p), pack_fleet(d), pack_fleet(vel))
    for n in SWEEPS:
        want_p, want_v = kjacobi.jacobi_project_plain(p, d, vel, n, float(PRESCALE))
        for packed, (pp, dd, vv) in ((False, (p, d, vel)), (True, packs)):
            got_p, got_v = _emulate_project(_flat(pp), _flat(dd), _flat(vv), n, tiles, b, h, w,
                                            packed, dt)
            assert not np.isnan(got_p).any() and not np.isnan(got_v).any(), (n, packed)
            wp, wv = ((pack_fleet(want_p), pack_fleet(want_v)) if packed else (want_p, want_v))
            np.testing.assert_array_equal(got_p, _flat(wp), err_msg=f"p n={n} packed={packed}")
            np.testing.assert_array_equal(got_v, _flat(wv), err_msg=f"v n={n} packed={packed}")


def test_fused_launch_rounds_the_pressure_before_the_gradient():
    """The fused launch's gradient reads the pressure as stored: without the
    rounding, a 16-bit transliteration departs from the plain pair."""
    h, w, dt = 48, 72, torch.bfloat16
    p, d, vel = _fields(np.random.default_rng(5), 1, h, w, dt)
    want = kjacobi.jacobi_project_plain(p, d, vel, 20, float(PRESCALE))[1]
    got = _emulate_project(_flat(p), _flat(d), _flat(vel), 20, kjacobi.SMALL, 1, h, w, False, dt)
    np.testing.assert_array_equal(got[1], _flat(want))
    unrounded = _emulate_project(_flat(p), _flat(d), _flat(vel), 20, kjacobi.SMALL, 1, h, w,
                                 False, torch.float32)[1]
    assert (_round(unrounded, dt) != _flat(want)).any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [0, 20])
def test_jacobi_project_plain_matches_jax(n, dtype):
    """jacobi_project_plain against the JAX package's jnp solve (the 0.8
    warm start, n sweeps) then its gradient subtract, from the same numpy
    inputs: within 1e-5 of the scale in float32, and within
    tests/test_torch_ops.py's 16-bit class (0.05 of the pressure, 0.02 of
    the velocity's scale) in bfloat16 and float16, where JAX runs in
    float32 on the stored inputs."""
    rng = np.random.default_rng(17 + n)
    h, w = 48, 72
    p, d, vel = (x[0] for x in _fields(rng, 1, h, w, DTYPES[dtype]))
    got_p, got_v = kjacobi.jacobi_project_plain(p, d, vel, n, float(PRESCALE))
    assert got_p.dtype == got_v.dtype == DTYPES[dtype]
    jp = jnp.asarray(p.float().numpy()) * jnp.float32(PRESCALE)
    if n:
        jp = jstencil.jacobi_pressure(jp, jnp.asarray(d.float().numpy()), n)
    jv = jstencil.gradient_subtract(jnp.asarray(vel.float().numpy()), jp)
    want_p, want_v = np.asarray(jp), np.asarray(jv)
    err_p = float(np.abs(got_p.float().numpy() - want_p).max())
    err_v = float(np.abs(got_v.float().numpy() - want_v).max())
    scale_p, scale_v = float(np.abs(want_p).max()), float(np.abs(want_v).max())
    if dtype == "float32":
        assert err_p <= 1e-5 * scale_p and err_v <= 1e-5 * scale_v, (err_p, err_v)
    else:
        assert err_p <= 0.05 and err_v <= 0.02 * scale_v, (err_p, err_v)


def test_project_plan_and_cut():
    """The fused launch's halo is K + 1: 64x128 regions at K = 10 give
    42x106 tiles (44x108 for a chunk), 32x64 ones 10x42 (12x44); it runs 0
    to max_sweeps - 1 sweeps; a solve of no sweeps is one fused launch of
    none; check_cut knows the last launch is the fused one."""
    large, small = kjacobi.TILES[kjacobi.LARGE], kjacobi.TILES[kjacobi.SMALL]
    assert (large.tile(10), large.tile(10, True)) == ((44, 108), (42, 106))
    assert (small.tile(10), small.tile(10, True)) == ((12, 44), (10, 42))
    assert (large.max_sweeps(True), small.max_sweeps(True)) == (30, 14)
    # 1024^2: 24 x 10 chunk tiles, 25 x 10 fused ones; the demo 11 x 6, 13 x 6
    assert (large.blocks(1024, 1024, 10), large.blocks(1024, 1024, 10, True)) == (240, 250)
    assert (small.blocks(128, 228, 10), small.blocks(128, 228, 10, True)) == (66, 78)
    for n, cut in ((0, [0]), (1, [1]), (10, [10]), (11, [10, 1]), (20, [10, 10]),
                   (23, [10, 10, 3])):
        assert kjacobi.plan(1024, 1024, n, 132, project=True) == (kjacobi.LARGE, cut)
        assert kjacobi.plan(128, 228, n, 132, project=True) == (kjacobi.SMALL, cut)
        assert kjacobi.plan(128, 228, n, 132)[1] == (cut if n else [])
    for tiles, t in ((kjacobi.LARGE, large), (kjacobi.SMALL, small)):
        kjacobi.check_cut(tiles, [0], project=True)
        kjacobi.check_cut(tiles, [t.max_sweeps(), t.max_sweeps(True)], project=True)
        for cut in ([], [t.max_sweeps(), t.max_sweeps(True) + 1], [0, 0], [-1]):
            with pytest.raises(ValueError, match="cannot run sweeps"):
                kjacobi.check_cut(tiles, cut, project=True)
        with pytest.raises(ValueError, match="cannot run sweeps"):
            kjacobi.check_cut(tiles, [0])


def test_project_work_models_hand_counts():
    """The fused solve's cell-sweeps and bytes beside the function's: at
    1024^2 bf16 a chunk of 240 64x128 regions and a fused launch of 250,
    10 sweeps each; the bytes each block's region of the pressure and the
    divergence, the scratch between them, the velocity once."""
    h = w = 1024
    assert kjacobi.design_cell_sweeps(h, w, 20, 132, project=True) == (240 + 250) * 64 * 128 * 10
    assert kjacobi.design_cell_sweeps(h, w, 20, 132) == 2 * 240 * 64 * 128 * 10
    assert kjacobi.design_cell_sweeps(h, w, 0, 132, project=True) == 0
    region = 64 * 128
    want = 240 * region * (2 + 2) + h * w * 4 + 250 * region * (4 + 2) + h * w * 2 + 4 * h * w * 2
    assert kjacobi.design_bytes(h, w, 20, 132, 2) == want
    assert kjacobi.function_bytes(h, w, 2) == 7 * h * w * 2
    # no sweep: one fused launch of 1-cell halos
    blocks = math.ceil(h / 62) * math.ceil(w / 126)
    assert kjacobi.design_bytes(h, w, 0, 132, 2) == \
        blocks * region * 4 + h * w * 2 + 4 * h * w * 2


def test_jacobi_project_wrapper_refuses_cpu_tensors():
    """A CPU tensor has no kernel: the wrapper raises (dispatch runs the
    plain pair there); the kernel is counted apart from the chunks."""
    p, d, vel = (x[0] for x in _fields(np.random.default_rng(3), 1, 8, 8, torch.float32))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kjacobi.jacobi_project(p, d, vel, 20, 0.8)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kjacobi.run_project(p, d, vel, 0.8, [10, 10])
    assert {"jacobi_chunk", "jacobi_project", "gradient_subtract"} <= set(build.KERNELS)
    assert build.KERNELS["jacobi_project"].source == "jacobi"



def test_step_rates_drives_every_cell(monkeypatch):
    """tools/step_rates.py's cells through the entry points, on the CPU at
    32^2 (3 sims a fleet): each call advances the state, finite and moving."""
    import dataclasses

    from tpufluid_torch.tools import step_rates

    full = step_rates._config
    monkeypatch.setattr(step_rates, "_config", lambda cell: dataclasses.replace(
        full(cell), SIM_RESOLUTION=32, DYE_RESOLUTION=32, CANVAS_WIDTH=32,
        CANVAS_HEIGHT=32).validate())
    monkeypatch.setattr(step_rates, "FLEET", (32, 3))
    monkeypatch.setattr(step_rates, "WARM", 1)
    for cell in step_rates.CELLS:
        one, box = step_rates._caller(cell, 1, "cpu")
        before = box[0]
        one(0)
        v = box[0].velocity.float()
        assert box[0] is not before and bool(torch.isfinite(v).all()), cell
        assert float(v.abs().max()) > 0.0, cell
