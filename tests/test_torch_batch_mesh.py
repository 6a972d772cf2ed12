"""The port's batch-mesh modes (tpufluid_torch/batch.py's mesh half,
serve_batch.make_batch_sharded_substepped_tick, parallel/auto.py) on the
CPU: against tpufluid's on its 8 virtual CPU devices (tests/conftest.py),
and against the port's own unsharded and single-sim paths, bit for bit.

The JAX side runs its jnp path (USE_PALLAS=False), the port its plain
passes on a mesh of ["cpu"] * n; both start from the same numpy-seeded
states (smooth random fields), carried across by tpufluid_torch.interop, at
tests/test_batch.py's _cfg (sim 64, dye 128, canvas 128^2, MAX_SPLATS 4).
Tolerances against JAX, as fractions of each field's scale, those of the
port's tests of the same comparison: batch DP 1e-3 (tests/test_torch_batch.py,
float32 after 3 steps), the substepped tick's state 1e-3 and its frames
within one count; batch x spatial 1e-4 after the first step and 1e-3 after
(tests/test_torch_sharding.py:276); the auto-sharded step 1e-3 after 5
steps (tests/test_torch_step.py's class after several steps). Within the
port every comparison is exact.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufluid import FluidConfig as JaxConfig
from tpufluid.batch import make_batch_sharded_multi_step as jax_dp_multi
from tpufluid.batch import make_batch_spatial_mesh as jax_bs_mesh
from tpufluid.batch import make_batch_spatial_multi_step as jax_bs_multi
from tpufluid.batch import shard_batch as jax_shard_batch
from tpufluid.batch import shard_batch_spatial as jax_shard_bs
from tpufluid.parallel import make_mesh as jax_mesh
from tpufluid.parallel import shard_state as jax_shard
from tpufluid.parallel.auto import make_auto_sharded_step as jax_auto
from tpufluid.serve_batch import make_batch_sharded_substepped_tick as jax_dp_tick
import tpufluid_torch as T
from tpufluid_torch.batch import stack_states, unstack_state
from tpufluid_torch.interop import config_from_dict, state_from_numpy, state_to_numpy
from tpufluid_torch.ops.cuda import check
from tpufluid_torch.parallel import halo
from tpufluid_torch.parallel import sharded_step
from tpufluid_torch.parallel.mesh import gather_state

FIELDS = ("velocity", "dye", "pressure")
DT = np.float32(1 / 60)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch intra-op thread for this module: the suite runs files in
    parallel workers, and each worker's full thread pool oversubscribes the
    cores (these tests ran 20x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(**kw):
    base = dict(SIM_RESOLUTION=64, DYE_RESOLUTION=128, CANVAS_WIDTH=128, CANVAS_HEIGHT=128,
                MAX_SPLATS=4, USE_PALLAS=False)
    return JaxConfig(**{**base, **kw}).validate()


def _tcfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _smooth(rng, shape, amp):
    """A smooth random field (..., H, W): a few sinusoids of random phase."""
    h, w = shape[-2:]
    y, x = np.meshgrid(np.arange(h) / h, np.arange(w) / w, indexing="ij")
    out = np.zeros(shape)
    for _ in range(3):
        ky, kx = rng.integers(1, 4, 2)
        phase = rng.random(shape[:-2] + (1, 1)) * 2 * np.pi
        out += np.sin(2 * np.pi * (ky * y + kx * x) + phase)
    return (amp * out / 3).astype(np.float32)


def _numpy_batch(cfg, b, seed):
    """(velocity, dye, pressure) numpy float32 fields of B distinct sims."""
    rng = np.random.default_rng(seed)
    (sw, sh), (dw, dh) = cfg.sim_size, cfg.dye_size
    vel = _smooth(rng, (b, 2, sh, sw), 200.0)
    dye = np.abs(_smooth(rng, (b, 3, dh, dw), 1.0))
    p = _smooth(rng, (b, sh, sw), 0.5)
    return vel, dye, p


def _seq(cfg, steps, b, seed=70):
    return np.stack([T.swirl_trace(cfg, steps, seed=seed + i).batches for i in range(b)],
                    axis=1)


def _port_batch(cfg, b, seed):
    return state_from_numpy(*_numpy_batch(cfg, b, seed), device="cpu")


def _jax_batch(jcfg, b, seed):
    from tpufluid.state import FluidState as JaxState

    vel, dye, p = _numpy_batch(jcfg, b, seed)
    return JaxState(velocity=jnp.asarray(vel, jcfg.dtype), dye=jnp.asarray(dye, jcfg.dtype),
                    pressure=jnp.asarray(p, jcfg.dtype))


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-3)


def _jax_fields(state):
    return [np.asarray(getattr(state, f), np.float32) for f in FIELDS]


def _equal(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


def _cpu_mesh(shape):
    return T.make_mesh(devices=["cpu"] * (shape[0] * shape[1]), shape=shape)


def _bs_mesh(shape):
    return T.make_batch_spatial_mesh(shape, devices=["cpu"] * (shape[0] * shape[1] * shape[2]))


def _per_sim(steps, b):
    return np.broadcast_to(np.linspace(1 / 90, 1 / 60, b, dtype=np.float32), (steps, b))


def _substep_dts(b, k):
    """(K, B): 1..K substeps a sim, distinct sub-dts (tests/test_batch.py:215)."""
    n_sub = (np.arange(b) % k) + 1
    subs = np.linspace(1 / 120, 1 / 60, b).astype(np.float32)
    return np.where(np.arange(k)[:, None] < n_sub[None, :], subs[None, :], 0.0
                    ).astype(np.float32)


# ------------------------------------------------------------ against tpufluid


@pytest.fixture(scope="module")
def dp_jax():
    """JAX's batch-DP multi-step (per-sim dts, B = 8 on (8, 1)) and its
    K = 3 substepped tick, on the same inputs the port's tests take."""
    jcfg = _jcfg()
    b, steps = 8, 2
    seq = _seq(_tcfg(jcfg), steps, b)
    mesh = jax_mesh()
    multi = jax_dp_multi(jcfg, mesh)(jax_shard_batch(_jax_batch(jcfg, b, 1), mesh),
                                     jnp.asarray(_per_sim(steps, b)), jnp.asarray(seq))
    state, frames = jax_dp_tick(jcfg, mesh)(jax_shard_batch(_jax_batch(jcfg, b, 2), mesh),
                                           jnp.asarray(_substep_dts(b, 3)), jnp.asarray(seq[0]))
    return {"multi": _jax_fields(multi), "tick": _jax_fields(state),
            "frames": np.asarray(frames), "seq": seq}


def test_batch_sharded_multi_step_matches_jax(dp_jax):
    """Per-sim dts, B = 8 on an (8, 1) mesh: every sim within 1e-3 of JAX's
    make_batch_sharded_multi_step after 2 steps."""
    cfg = _tcfg(_jcfg())
    mesh = _cpu_mesh((8, 1))
    out = T.make_batch_sharded_multi_step(cfg, mesh)(T.shard_batch(_port_batch(cfg, 8, 1), mesh),
                                                     _per_sim(2, 8), dp_jax["seq"])
    for name, g, w in zip(FIELDS, state_to_numpy(T.gather_batch(out)), dp_jax["multi"]):
        assert g.shape == w.shape
        for i in range(8):
            assert _rel(g[i], w[i]) < 1e-3, (name, i, _rel(g[i], w[i]))


def test_batch_sharded_substepped_tick_matches_jax(dp_jax):
    """K = 3 with 1..3 substeps a sim: each sim's state within 1e-3 of JAX's
    make_batch_sharded_substepped_tick, its frame within one count."""
    cfg = _tcfg(_jcfg())
    mesh = _cpu_mesh((8, 1))
    state, frames = T.make_batch_sharded_substepped_tick(cfg, mesh)(
        T.shard_batch(_port_batch(cfg, 8, 2), mesh), _substep_dts(8, 3), dp_jax["seq"][0])
    for name, g, w in zip(FIELDS, state_to_numpy(T.gather_batch(state)), dp_jax["tick"]):
        for i in range(8):
            assert _rel(g[i], w[i]) < 1e-3, (name, i, _rel(g[i], w[i]))
    assert frames.dtype == torch.uint8 and frames.shape == dp_jax["frames"].shape
    assert int(np.abs(frames.numpy().astype(int) - dp_jax["frames"].astype(int)).max()) <= 1


def test_batch_spatial_multi_step_matches_jax():
    """(2, 2, 2), B = 4, per-sim dts: each field within 1e-4 of the scale of
    JAX's make_batch_spatial_multi_step after one step, 1e-3 after two."""
    jcfg, shape, b = _jcfg(), (2, 2, 2), 4
    cfg = _tcfg(jcfg)
    seq = _seq(cfg, 2, b)
    jmesh, tmesh = jax_bs_mesh(shape), _bs_mesh(shape)
    jmulti, tmulti = jax_bs_multi(jcfg, jmesh), T.make_batch_spatial_multi_step(cfg, tmesh)
    js, ts = jax_shard_bs(_jax_batch(jcfg, b, 3), jmesh), T.shard_batch_spatial(
        _port_batch(cfg, b, 3), tmesh)
    for t, tol in ((0, 1e-4), (1, 1e-3)):
        dt = _per_sim(1, b)
        js = jmulti(js, jnp.asarray(dt), jnp.asarray(seq[t:t + 1]))
        ts = tmulti(ts, dt, seq[t:t + 1])
        for name, g, w in zip(FIELDS, state_to_numpy(T.gather_batch_spatial(ts)),
                              _jax_fields(js)):
            assert g.shape == w.shape
            assert _rel(g, w) < tol, (t, name, _rel(g, w))


def test_auto_sharded_step_matches_jax():
    """make_auto_sharded_step on an (8, 1) mesh over 5 steps, against JAX's
    GSPMD make_auto_sharded_step: within 1e-3 of the scale; the result cut
    back into the mesh's blocks."""
    jcfg = _jcfg(CANVAS_WIDTH=64, CANVAS_HEIGHT=64)
    cfg = _tcfg(jcfg)
    trace = T.swirl_trace(cfg, 5, seed=11)
    jmesh, tmesh = jax_mesh(), _cpu_mesh((8, 1))
    jstep, tstep = jax_auto(jcfg, jmesh), T.make_auto_sharded_step(cfg, tmesh)
    one = _numpy_batch(jcfg, 1, 4)
    from tpufluid.state import FluidState as JaxState
    js = jax_shard(JaxState(*(jnp.asarray(a[0]) for a in one)), jmesh)
    ts = T.shard_state(state_from_numpy(*(a[0] for a in one), device="cpu"), tmesh)
    for t in range(5):
        js = jstep(js, DT, jnp.asarray(trace.batches[t]))
        ts = tstep(ts, DT, trace.batches[t])
    assert len(ts) == 8 and ts[0][0].velocity.shape == (2, 8, 64)
    for name, g, w in zip(FIELDS, state_to_numpy(gather_state(ts)), _jax_fields(js)):
        assert _rel(g, w) < 1e-3, (name, _rel(g, w))


# -------------------------------------------------- the port's own contract


@pytest.mark.parametrize("kind", ["lock-step", "per-sim", "substepped-tick"])
def test_batch_dp_equals_unsharded_batch(kind):
    """Batch DP on (4, 2) (one sim a device) and on (2, 1) (4 a device)
    equals the unsharded batch bit for bit, the tick's frames included, and
    moves no byte between devices (halo.SENT stays 0); every output slice
    stays on its input's device."""
    cfg = _tcfg(_jcfg())
    b = 8
    seq = _seq(cfg, 2, b)
    for shape in ((4, 2), (2, 1)):
        mesh = _cpu_mesh(shape)
        start = _port_batch(cfg, b, 5)
        halo.SENT.reset()
        if kind == "substepped-tick":
            dts = _substep_dts(b, 3)
            want, want_frames = T.make_substepped_tick(cfg, device="cpu")(start, dts, seq[0])
            got, frames = T.make_batch_sharded_substepped_tick(cfg, mesh)(
                T.shard_batch(start, mesh), dts, seq[0])
            assert torch.equal(frames, want_frames), shape
        else:
            dt = DT if kind == "lock-step" else _per_sim(2, b)
            want = T.make_batched_multi_step(cfg, device="cpu")(start, dt, seq)
            got = T.make_batch_sharded_multi_step(cfg, mesh)(T.shard_batch(start, mesh), dt,
                                                             seq)
        assert halo.SENT.bytes == 0
        assert len(got) == mesh.size
        assert all(s.velocity.device == d for s, d in zip(got, mesh.flat))
        assert _equal(T.gather_batch(got), want), (kind, shape)


def _count_split(monkeypatch):
    calls = {"n": 0}
    orig = sharded_step._overlap_rows

    def counted(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(sharded_step, "_overlap_rows", counted)
    return calls


@pytest.mark.parametrize("shape,per_group,kw", [
    ((2, 2, 2), 2, dict()),
    ((4, 2, 1), 2, dict()),
    ((2, 2, 2), 3, dict(SIM_RESOLUTION=32, DYE_RESOLUTION=128, DTYPE="bfloat16")),
    ((4, 2, 1), 3, dict(SIM_RESOLUTION=32, DYE_RESOLUTION=128, DTYPE="bfloat16")),
    ((1, 2, 1), 2, dict(SIM_RESOLUTION=256, DYE_RESOLUTION=512, OVERLAP_HALO=True)),
], ids=["222-f32", "421-f32", "222-bf16-rgb9e5", "421-bf16-rgb9e5", "121-split"])
def test_batch_spatial_sims_equal_single_sim_sharded_step(shape, per_group, kw, monkeypatch):
    """Each sim of make_batch_spatial_multi_step (per-sim dts) equals its
    single-sim sharded step on its group's mesh with its own dt, bit for
    bit: f32 at 64/128, two sims a group; bf16 with the RGB9E5 dye at the
    cross grid 32/128, three a group (the batched velocity resampled on the
    dye's grid, channel by channel); and with OVERLAP_HALO where the shards
    hold an interior band (every phase split: the factors' row slices)."""
    cfg = _tcfg(_jcfg(**kw))
    assert cfg.DYE_RGB9E5 or cfg.dtype != torch.bfloat16
    calls = _count_split(monkeypatch)
    steps = 1 if cfg.overlap_halo else 2
    b = per_group * shape[0]
    start, splats = check.random_batch(cfg, b, 3, "cpu")
    seq = np.concatenate([splats.numpy()[None], _seq(cfg, steps - 1, b)])
    dts = _per_sim(steps, b)
    mesh = _bs_mesh(shape)
    got = T.gather_batch_spatial(T.make_batch_spatial_multi_step(cfg, mesh)(
        T.shard_batch_spatial(start, mesh), dts, seq))
    assert (calls["n"] > 0) == cfg.overlap_halo
    for i in range(b):
        group = mesh.groups[i // per_group]
        one = T.make_sharded_multi_step(cfg, group)(
            T.shard_state(unstack_state(start, i), group), dts[:, i], seq[:, i])
        assert _equal(unstack_state(got, i), gather_state(one)), i


def test_batch_spatial_groups_do_not_leak():
    """Swapping two groups' inputs (states, splats, dts) swaps their
    outputs, bit for bit: no group reads another's fields, splats or dt
    table, though all share one device."""
    cfg = _tcfg(_jcfg())
    mesh = _bs_mesh((2, 2, 2))
    multi = T.make_batch_spatial_multi_step(cfg, mesh)
    start = _port_batch(cfg, 4, 6)
    seq = _seq(cfg, 2, 4)
    dts = np.ascontiguousarray(_per_sim(2, 4))
    swap = [2, 3, 0, 1]
    a = T.gather_batch_spatial(multi(T.shard_batch_spatial(start, mesh), dts, seq))
    swapped = stack_states([unstack_state(start, i) for i in swap])
    b = T.gather_batch_spatial(multi(T.shard_batch_spatial(swapped, mesh), dts[:, swap],
                                     seq[:, swap]))
    for i, j in enumerate(swap):
        assert _equal(unstack_state(b, i), unstack_state(a, j)), i
    assert not _equal(unstack_state(a, 0), unstack_state(a, 2))


def test_shard_and_gather_batch_round_trip():
    cfg = _tcfg(_jcfg())
    start = _port_batch(cfg, 8, 7)
    mesh = _cpu_mesh((4, 2))
    shards = T.shard_batch(start, mesh)
    assert [s.velocity.shape[0] for s in shards] == [1] * 8
    assert _equal(T.gather_batch(shards), start)
    bs = T.shard_batch_spatial(start, _bs_mesh((2, 2, 2)))
    assert len(bs) == 2 and bs[1][1][1].dye.shape == (4, 3, 64, 64)
    assert _equal(T.gather_batch_spatial(bs), start)
    shards[0].velocity.add_(1.0)   # a copy, not a view of the input
    assert _equal(T.gather_batch(T.shard_batch(start, mesh)), start)


def test_batch_mesh_errors():
    """JAX's errors: a batch the mesh does not divide ("not divisible"),
    grid extents that do not divide the spatial axes ("must divide", at
    construction), a (B,) dt ("per-sim dts for multi-step")."""
    cfg = _tcfg(_jcfg())
    start = _port_batch(cfg, 3, 8)
    zeros = np.zeros((1, 3, cfg.MAX_SPLATS, 8), np.float32)
    mesh = _cpu_mesh((2, 1))
    with pytest.raises(ValueError, match="not divisible"):
        T.shard_batch(start, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        T.make_batch_sharded_multi_step(cfg, mesh)((start, start), DT, zeros)
    with pytest.raises(ValueError, match="not divisible"):
        T.make_batch_sharded_substepped_tick(cfg, mesh)((start, start), np.full((2, 3), DT),
                                                        zeros[0])
    bs_mesh = _bs_mesh((2, 2, 2))
    with pytest.raises(ValueError, match="not divisible"):
        T.shard_batch_spatial(start, bs_mesh)
    with pytest.raises(ValueError, match="not divisible"):
        T.make_batch_spatial_multi_step(cfg, bs_mesh)((), DT, zeros)
    with pytest.raises(ValueError, match="must divide"):
        T.make_batch_spatial_multi_step(cfg, _bs_mesh((2, 3, 1)))
    four = _port_batch(cfg, 4, 8)
    seq = np.zeros((3, 4, cfg.MAX_SPLATS, 8), np.float32)
    with pytest.raises(ValueError, match="per-sim dts for multi-step"):
        T.make_batch_sharded_multi_step(cfg, mesh)(T.shard_batch(four, mesh),
                                                   np.full(4, DT), seq)
    with pytest.raises(ValueError, match="per-sim dts for multi-step"):
        T.make_batch_spatial_multi_step(cfg, bs_mesh)(T.shard_batch_spatial(four, bs_mesh),
                                                      np.full(4, DT), seq)


def test_batch_spatial_mesh_layout_and_devices(monkeypatch):
    """An (nb, ny, nx) mesh is nb (ny, nx) Meshes over ('b', 'y', 'x'); a
    mesh of CPU and CUDA devices raises; without a GPU and without
    ``devices`` it raises, as make_mesh() does."""
    mesh = _bs_mesh((2, 2, 1))
    assert mesh.shape == (2, 2, 1) and mesh.size == 4
    assert mesh.axis_names == ("b", "y", "x") and T.batch.BATCH_AXIS == "b"
    assert all(g.shape == (2, 1) for g in mesh.groups)
    with pytest.raises(ValueError):
        T.make_batch_spatial_mesh((2, 1, 1), devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError):
        T.make_batch_spatial_mesh((2, 2, 1), devices=["cpu"] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.make_batch_spatial_mesh((1, 1, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        T.make_auto_sharded_step(_tcfg(_jcfg()))


def test_sharded_departure_tool_runs():
    """tools/sharded_departure.py on the split geometry, one step: a record
    a step, every sim's departure finite and in the f32 noise class."""
    from tpufluid_torch.tools import sharded_departure

    recs = sharded_departure.run("split", "float32", (1, 2, 1), 1, 42, None,
                                 torch.device("cpu"))
    assert len(recs) == 1 and len(recs[0]["sims"]) == 2
    for sim in recs[0]["sims"]:
        for own, batch in sim.values():
            assert 0.0 <= batch <= own < 1e-4
    assert set(recs[0]["worst_dye"]) == {"sim", "channel", "row", "col",
                                         "texels_from_shard_edge"}


def test_new_modules_import_neither_jax_nor_tpufluid():
    repo = Path(__file__).resolve().parents[1]
    code = (
        "import sys, importlib\n"
        "for m in ('tpufluid_torch.batch', 'tpufluid_torch.serve_batch',\n"
        "          'tpufluid_torch.parallel.auto', 'tpufluid_torch.dryrun',\n"
        "          'tpufluid_torch.tools.fidelity_drift',\n"
        "          'tpufluid_torch.tools.sharded_departure'):\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpufluid')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
