"""Driver entry points: the flagship step and the multi-device dry run.

Counterpart of __graft_entry__.py. ``entry()`` gives the one-device step on
the flagship 128/512 config; ``dryrun_multichip(n)`` drives every
distributed mode the port ships over a mesh of n devices and certifies each
against its one-device truth, at the JAX package's geometries and
tolerances:

  * the sharded step and multi-step against the one-device step on the
    (n / 2, 2) and (n, 1) meshes: within 2e-4 of each field's scale;
  * the sharded step through the kernels against the sharded step through
    the plain passes (the port's form of _certify_pallas_kernels_sharded):
    bit-equal on a CUDA mesh; on a CPU mesh both are the plain passes;
  * batch data parallelism, lock-step and per-sim dts, and the K = 3
    substepped tick: bit-equal to the unsharded batch, frames included;
  * batch x spatial: within 4e-4 of each field's scale.

By default the mesh is every visible GPU taken round robin up to n devices
(on one card, n shards all on it); ``devices=["cpu"] * n`` runs it on the
CPU through the plain passes. Each certification raises AssertionError on
a failure and the dry run returns the errors it measured.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from tpufluid_torch.batch import (gather_batch, gather_batch_spatial,
                                  make_batch_sharded_multi_step, make_batch_spatial_mesh,
                                  make_batch_spatial_multi_step, make_batched_multi_step,
                                  shard_batch, shard_batch_spatial, stack_states)
from tpufluid_torch.config import FluidConfig
from tpufluid_torch.ops.cuda import build
from tpufluid_torch.parallel.mesh import gather_state, make_mesh, shard_state
from tpufluid_torch.parallel.sharded_step import (make_sharded_multi_step, make_sharded_step,
                                                  plain_sharded_step, sharded_fluid_step)
from tpufluid_torch.serve_batch import make_batch_sharded_substepped_tick, make_substepped_tick
from tpufluid_torch.state import FluidState, init_state, resolve_device
from tpufluid_torch.step import fluid_step
from tpufluid_torch.trace import swirl_trace

_FIELDS = ("velocity", "dye", "pressure")
_DT = np.float32(1.0 / 60.0)


def entry(device="cuda"):
    """(fn, example_args) of one step on the flagship config (sim 128, dye
    512, canvas 512x512) on ``device`` (default the GPU)."""
    device = resolve_device(device)
    config = FluidConfig(SIM_RESOLUTION=128, DYE_RESOLUTION=512, CANVAS_WIDTH=512,
                         CANVAS_HEIGHT=512).validate()
    state = init_state(config, device=device)
    trace = swirl_trace(config, 1, seed=0)

    def fn(state, dt, splats):
        return fluid_step(state, dt, splats, config)

    return fn, (state, _DT, torch.as_tensor(trace.batches[0], device=device))


def _devices(n_devices: int, devices: Optional[Sequence]):
    if devices is not None:
        devices = [torch.device(d) for d in devices][:n_devices]
        if len(devices) != n_devices:
            raise ValueError(f"{len(devices)} devices for a dry run over {n_devices}")
        return devices
    if not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip() takes the visible CUDA devices and there is "
                           "none; pass devices=['cpu'] * n for a dry run on the CPU")
    cards = torch.cuda.device_count()
    return [torch.device("cuda", k % cards) for k in range(n_devices)]


def _fields(state: FluidState):
    return {f: getattr(state, f).detach().to("cpu", torch.float32).numpy() for f in _FIELDS}


def _rel_errs(truth: FluidState, got: FluidState, what: str, bound: float) -> dict:
    """Each field's max abs difference over max(its scale, 1e-3), held under
    ``bound``; the got fields finite."""
    errs, have = {}, _fields(got)
    for f, a in _fields(truth).items():
        b = have[f]
        assert np.isfinite(b).all(), f"{what} {f}: non-finite"
        errs[f] = float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-3)
        assert errs[f] < bound, f"{what} {f}: rel err {errs[f]:.2e} >= {bound:.0e}"
    return errs


def _assert_equal(truth: FluidState, got: FluidState, what: str) -> None:
    for f in _FIELDS:
        a, b = getattr(truth, f), getattr(got, f)
        assert bool(torch.isfinite(b.float()).all()), f"{what} {f}: non-finite"
        assert torch.equal(a, b.to(a.device)), f"{what} {f}: differs"


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """Run the sharded step (one step, then a (steps - 1)-step multi-step)
    over an n-device 2-D mesh, rows x columns and rows only, and certify it
    against the one-device step; then the kernels on the shards, batch data
    parallelism and batch x spatial (module docstring). Returns each
    certification's measured errors."""
    devices = _devices(n_devices, devices)
    sim = max(16 * n_devices, 32)
    config = FluidConfig(SIM_RESOLUTION=sim, DYE_RESOLUTION=2 * sim, CANVAS_WIDTH=sim,
                         CANVAS_HEIGHT=sim, MAX_SPLATS=4).validate()
    steps = 3
    batches = swirl_trace(config, steps, seed=0).batches

    # One-device truth on the same trace.
    truth = init_state(config, device=devices[0])
    for t in range(steps):
        truth = fluid_step(truth, _DT, batches[t], config)

    # Both mesh layouts: the 2-D decomposition and rows only.
    shapes = [(n_devices, 1)]
    if n_devices % 2 == 0 and n_devices > 1:
        shapes.insert(0, (n_devices // 2, 2))
    out = {"sharded": {}}
    for shape in shapes:
        mesh = make_mesh(devices=devices, shape=shape)
        step = make_sharded_step(config, mesh)
        multi = make_sharded_multi_step(config, mesh)
        s8 = step(shard_state(init_state(config, device=devices[0]), mesh), _DT, batches[0])
        s8 = multi(s8, _DT, batches[1:])
        # Same math on padded blocks, whose backtrace coordinates round
        # otherwise than the whole grid's: the JAX package's bound.
        out["sharded"][f"{shape[0]}x{shape[1]}"] = _rel_errs(
            truth, gather_state(s8, devices[0]), f"sharded@{shape}", 2e-4)

    out["kernels_sharded"] = _certify_kernels_sharded(n_devices, devices)
    out["batch_dp"] = _certify_batch_dp(n_devices, devices)
    out["batch_spatial"] = _certify_batch_spatial(n_devices, devices)
    return out


def _certify_kernels_sharded(n_devices: int, devices) -> dict:
    """The sharded step through the kernels against the same step through
    the plain passes on the rows mesh, at the smallest geometry whose shards
    the JAX package's kernel gates take (32-row sim shards, 64-row dye
    shards): bit-equal. On a CUDA mesh the kernels must have launched."""
    sim = max(32 * n_devices, 64)
    config = FluidConfig(SIM_RESOLUTION=sim, DYE_RESOLUTION=2 * sim, CANVAS_WIDTH=2 * sim,
                         CANVAS_HEIGHT=2 * sim, MAX_SPLATS=4).validate()
    mesh = make_mesh(devices=devices, shape=(n_devices, 1))
    splats = swirl_trace(config, 1, seed=3).batches[0]
    before = sum(k.launches for k in build.KERNELS.values())
    a = sharded_fluid_step(shard_state(init_state(config, device=devices[0]), mesh), _DT,
                           splats, config)
    launches = sum(k.launches for k in build.KERNELS.values()) - before
    if devices[0].type == "cuda":
        assert launches >= 6 * n_devices, f"the kernels did not engage ({launches} launches)"
    b = plain_sharded_step(shard_state(init_state(config, device=devices[0]), mesh), _DT,
                           splats, config)
    _assert_equal(gather_state(b), gather_state(a), "sharded kernels vs plain passes")
    return {"launches": launches, "max_abs_err": 0.0}


def _certify_batch_dp(n_devices: int, devices) -> dict:
    """Batch data parallelism on the (n, 1) mesh, one sim a device: the
    multi-step under a lock-step and a (T, B) per-sim dt, then the K = 3
    substepped tick with 1..3 substeps a sim (masked rows on some devices
    only), each bit-equal to the unsharded batch, frames included."""
    config = FluidConfig(SIM_RESOLUTION=32, DYE_RESOLUTION=64, CANVAS_WIDTH=64,
                         CANVAS_HEIGHT=64, MAX_SPLATS=4).validate()
    b, steps = n_devices, 2
    splats_seq = np.stack([swirl_trace(config, steps, seed=7 + i).batches for i in range(b)],
                          axis=1)
    mesh = make_mesh(devices=devices, shape=(n_devices, 1))
    home = devices[0]
    dts = {"lock-step": _DT,
           "per-sim": np.broadcast_to(np.linspace(1.0 / 90.0, 1.0 / 60.0, b,
                                                  dtype=np.float32), (steps, b))}
    for kind, dt in dts.items():
        batched = stack_states([init_state(config, device=home) for _ in range(b)])
        truth = make_batched_multi_step(config, device=home.type)(batched, dt, splats_seq)
        got = make_batch_sharded_multi_step(config, mesh)(shard_batch(batched, mesh), dt,
                                                          splats_seq)
        _assert_equal(truth, gather_batch(got, home), f"batch-DP ({kind} dt)")

    k = 3
    n_sub = (np.arange(b) % k) + 1
    subs = np.linspace(1 / 120, 1 / 60, b).astype(np.float32)
    dts_kb = np.where(np.arange(k)[:, None] < n_sub[None, :], subs[None, :], 0.0
                      ).astype(np.float32)
    batched = stack_states([init_state(config, device=home) for _ in range(b)])
    t_state, t_frames = make_substepped_tick(config, device=home.type)(batched, dts_kb,
                                                                       splats_seq[0])
    s_state, s_frames = make_batch_sharded_substepped_tick(config, mesh)(
        shard_batch(batched, mesh), dts_kb, splats_seq[0])
    _assert_equal(t_state, gather_batch(s_state, home), "substep batch-DP")
    assert torch.equal(t_frames, s_frames.to(t_frames.device)), \
        "substep batch-DP frames differ from unsharded"
    return {"max_abs_err": 0.0}


def _certify_batch_spatial(n_devices: int, devices) -> Optional[dict]:
    """Batch x spatial on an (n / 4, 2, 2) mesh (else (n / 2, 2, 1); none
    for an odd n), two sims a group with per-sim dts: within 4e-4 of each
    field's scale of the unsharded batched multi-step."""
    if n_devices % 4 == 0:
        shape = (n_devices // 4, 2, 2)
    elif n_devices % 2 == 0:
        shape = (n_devices // 2, 2, 1)
    else:
        return None
    sim = max(32 * shape[1], 32)
    config = FluidConfig(SIM_RESOLUTION=sim, DYE_RESOLUTION=2 * sim, CANVAS_WIDTH=2 * sim,
                         CANVAS_HEIGHT=2 * sim, MAX_SPLATS=4).validate()
    b, steps = shape[0] * 2, 2
    splats_seq = np.stack([swirl_trace(config, steps, seed=31 + i).batches for i in range(b)],
                          axis=1)
    dt = np.broadcast_to(np.linspace(1.0 / 90.0, 1.0 / 60.0, b, dtype=np.float32), (steps, b))
    home = devices[0]
    batched = stack_states([init_state(config, device=home) for _ in range(b)])
    truth = make_batched_multi_step(config, device=home.type)(batched, dt, splats_seq)
    mesh = make_batch_spatial_mesh(shape, devices)
    out = make_batch_spatial_multi_step(config, mesh)(shard_batch_spatial(batched, mesh), dt,
                                                      splats_seq)
    return _rel_errs(truth, gather_batch_spatial(out, home), f"batch-spatial@{shape}", 4e-4)
