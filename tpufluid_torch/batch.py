"""Batched serving mode: B independent sims advanced, and rendered, by one
set of launches.

Counterpart of the single-device half of tpufluid/batch.py (lines 50-165).
There ``jax.vmap`` over ``pallas_call`` adds a leading grid dimension to
each TPU kernel and dt becomes a (B, 1, 1) operand. Here every step kernel
takes the batch itself (the grid's z axis is the sim) and dt in one of two
forms: a number, every sim's (lock-step), or a table of each sim's clamped
dt and decay, computed on the host in float32 (step.dt_table) and copied to
the card once a call. A batched step makes the launches of one single-sim
step (5 at 20 Jacobi sweeps) and one set of splat factor ops, whatever B is.

Every field leads with the batch axis: velocity (B, 2, H, W), dye (B, 3,
Hd, Wd), pressure (B, H, W), splats (B, MAX_SPLATS, 8). Each sim of a
batched step equals the single-sim step on that sim, with its dt and its
splats, bit for bit: the kernels run each sim's operations unchanged, and
the plain versions run a CPU batch sim by sim.

A batched frame (``make_batched_render``) is one bloom pyramid launch, the
sunrays' two launches (march and blur) and one display launch for the B
sims, with one dither tile for every sim, as the JAX vmap broadcasts it;
each sim's frame equals render_frame on that sim, bit for bit.

Over a mesh of devices (tpufluid/batch.py:168-339), one process drives
every device, as in tpufluid_torch/parallel:

* Batch data parallelism (``shard_batch``, ``make_batch_sharded_multi_step``,
  and serve_batch.make_batch_sharded_substepped_tick): a batch-sharded
  state is a tuple of batched FluidStates, one a device of a (ny, nx) Mesh
  in row-major order (JAX's P((ROW_AXIS, COL_AXIS)) flattens the mesh so),
  each holding B / mesh.size consecutive sims on its device. Each device
  runs the batched step on its own slice: no byte moves between devices,
  and each sim equals the unsharded batch's bit for bit.
* Batch x spatial (``make_batch_spatial_mesh``, ``shard_batch_spatial``,
  ``make_batch_spatial_multi_step``): an (nb, ny, nx) mesh is nb groups,
  each a (ny, nx) Mesh; the state is a tuple of nb sharded states
  (parallel/mesh.py's ShardedState) of B / nb sims each, every shard's
  fields leading with that B. Group g runs the sharded step on its sims,
  B / nb in each launch; its halos stay within its own sharded state.

JAX's PartitionSpec helpers (``batch_specs``, ``batch_spatial_specs``) have
no counterpart: the layouts are the two paragraphs above. Where the mesh
puts several shards or slices on one card they run there one after another.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tpufluid_torch.config import FluidConfig
from tpufluid_torch.ops.cuda import dispatch
from tpufluid_torch.parallel import sharded_step as _sharded
from tpufluid_torch.parallel.mesh import (COL_AXIS, ROW_AXIS, Mesh, ShardedState, gather_state,
                                          make_mesh, shard_state)
from tpufluid_torch.render import plain_render, render_frame
from tpufluid_torch.spans import span
from tpufluid_torch.state import FluidState, init_state, resolve_device
from tpufluid_torch.step import _step, clamp_dt, dt_table

_FIELDS = ("velocity", "dye", "pressure")


def init_batch(config: FluidConfig, batch: int, device="cuda") -> FluidState:
    """Zeroed batched state: every field gains a leading (batch,) axis."""
    one = init_state(config, device=device)
    return FluidState(*(torch.zeros((batch,) + tuple(getattr(one, f).shape),
                                    dtype=config.dtype, device=one.velocity.device)
                        for f in _FIELDS))


def stack_states(states: Sequence[FluidState]) -> FluidState:
    """Stack per-sim states into one batched state (leading batch axis)."""
    return FluidState(*(torch.stack([getattr(s, f) for s in states]) for f in _FIELDS))


def unstack_state(batched: FluidState, i: int) -> FluidState:
    """Sim ``i`` of a batched state (views of its fields)."""
    return FluidState(*(getattr(batched, f)[i] for f in _FIELDS))


def _host(dt) -> np.ndarray:
    if isinstance(dt, torch.Tensor):
        dt = dt.detach().cpu().numpy()
    return np.asarray(dt, np.float32)


def _table(dts: np.ndarray, config: FluidConfig, device) -> torch.Tensor:
    """dt_table of the velocity's and the dye's dissipation on ``device``:
    (..., 2, B, 2), one copy."""
    table = dt_table(dts, (config.VELOCITY_DISSIPATION, config.DENSITY_DISSIPATION))
    with span("upload"):
        return torch.from_numpy(table).to(device)


def step_dt(dt, batch: int, config: FluidConfig, device):
    """The dt a batched step passes its kernels: a number (lock-step) as
    clamp_dt gives it, with no copy to the card; a (batch,) array as its
    (2, batch, 2) table on ``device``."""
    a = _host(dt)
    if a.ndim == 0:
        return clamp_dt(a)
    if a.shape != (batch,):
        raise ValueError(f"dt of shape {a.shape}: a batched step takes a scalar or one dt "
                         f"a sim, ({batch},)")
    return _table(a, config, device)


def _require_batch(state: FluidState, device: torch.device) -> int:
    if state.velocity.device.type != device.type:
        raise ValueError(f"state on {state.velocity.device}, made for {device}")
    if state.velocity.ndim != 4 or state.dye.ndim != 4:
        raise ValueError(f"a batched step or frame takes a batched state (B, 2, H, W), got "
                         f"velocity {tuple(state.velocity.shape)}")
    return state.velocity.shape[0]


def plain_batched_step(state: FluidState, dt, splats, config: FluidConfig) -> FluidState:
    """A batched step through the kernels' plain versions on any device, sim
    by sim: the reference the batched kernels are held to on the card."""
    b = state.velocity.shape[0]
    return _step(state, step_dt(dt, b, config, state.velocity.device), splats, config,
                 dispatch.PLAIN)


def make_batched_step(config: FluidConfig, device="cuda"):
    """step(batched_state, dt, splats) -> batched_state on ``device``
    (default the GPU): the kernels on the card, their plain versions on the
    CPU. ``splats`` is (B, MAX_SPLATS, 8); ``dt`` a scalar (lock-step) or
    (B,) per sim."""
    device = resolve_device(device)

    def step(state: FluidState, dt, splats) -> FluidState:
        b = _require_batch(state, device)
        return _step(state, step_dt(dt, b, config, state.velocity.device), splats, config,
                     dispatch.ROUTED)

    return step


def _multi_dts(dt, t: int, b: int):
    """A T-step call's dt on the host: the (T, B) float32 array of per-sim
    dts, or T clamped numbers (a scalar or (T,), lock-step across sims)."""
    a = _host(dt)
    # A 1-D dt is per time step, never per sim: a (B,) dt here raises
    # rather than being read as a time sequence (tpufluid/batch.py:109).
    if a.ndim == 1 and a.shape[0] not in (1, t):
        raise ValueError(f"1-D dt has length {a.shape[0]} but there are {t} steps; "
                         f"per-sim dts for multi-step must be (T, B) = ({t}, {b})")
    if a.ndim == 2:
        if a.shape != (t, b):
            raise ValueError(f"per-sim dt of shape {a.shape}, expected ({t}, {b})")
        return a
    if a.ndim > 2:
        raise ValueError(f"dt of shape {a.shape}: a scalar, (T,) or (T, B)")
    return [clamp_dt(x) for x in np.broadcast_to(a.reshape(-1), (t,))]


def _slice_dts(dts, lo: int, hi: int, config: FluidConfig, device):
    """The dt of each of T steps of sims lo .. hi - 1 on ``device``: their
    columns of a per-sim _multi_dts as one (T, 2, B, 2) table, copied once;
    lock-step numbers as they are."""
    return _table(dts[:, lo:hi], config, device) if isinstance(dts, np.ndarray) else dts


def make_batched_multi_step(config: FluidConfig, device="cuda"):
    """multi(batched_state, dt, splats_seq) -> batched_state: T batched
    steps in a Python loop. ``splats_seq`` is (T, B, MAX_SPLATS, 8); ``dt``
    a scalar or (T,) (lock-step across sims) or (T, B) per sim. The splats
    and a per-sim dt table go to the card once a call."""
    device = resolve_device(device)

    def multi(state: FluidState, dt, splats_seq) -> FluidState:
        b = _require_batch(state, device)
        seq = torch.as_tensor(splats_seq, dtype=torch.float32, device=state.velocity.device)
        t = seq.shape[0]
        if seq.ndim != 4 or seq.shape[1] != b:
            raise ValueError(f"splats_seq {tuple(seq.shape)}, expected ({t}, {b}, S, 8)")
        dts = _slice_dts(_multi_dts(dt, t, b), 0, b, config, state.velocity.device)
        for k in range(t):
            state = _step(state, dts[k], seq[k], config, dispatch.ROUTED)
        return state

    return multi


# A batched frame through the kernels' plain versions on any device, sim by
# sim: the reference the batched render kernels are held to on the card.
# plain_render takes a batched state as it is.
plain_batched_render = plain_render


def make_batched_render(config: FluidConfig, out_hw: Optional[Tuple[int, int]] = None,
                        to_screen: bool = True, device="cuda"):
    """render(batched_state, dither=None) -> (B, 4, h, w) float32 frames on
    ``device`` (default the GPU): one bloom launch, the sunrays' two and one
    display launch for the B sims on the card, their plain versions on the
    CPU. ``dither`` is one
    (h, w) tile shared by every sim (tpufluid/batch.py:150-151)."""
    device = resolve_device(device)

    def render(state: FluidState, dither: Optional[torch.Tensor] = None) -> torch.Tensor:
        _require_batch(state, device)
        return render_frame(state, config, out_hw, to_screen, dither)

    return render


# ---------------------------------------------------------------------------
# Batch data parallelism over a device mesh (zero bytes between devices).
# ---------------------------------------------------------------------------

# A batch-sharded state: mesh.size batched FluidStates, slice k on
# mesh.flat[k] holding sims k * B / n .. (k + 1) * B / n - 1.
BatchShards = Tuple[FluidState, ...]


def _split(b: int, n: int, what: str) -> int:
    if b % n:
        raise ValueError(f"batch {b} not divisible by {what} {n}")
    return b // n


def shard_batch(state: FluidState, mesh: Mesh) -> BatchShards:
    """Split a batched state over ``mesh``, batch-axis sharded: B / mesh.size
    consecutive sims a device, row-major, each slice copied to its device.
    Raises ValueError where mesh.size does not divide B."""
    m = _split(state.velocity.shape[0], mesh.size, "mesh size")
    return tuple(FluidState(*(getattr(state, f)[k * m:(k + 1) * m].to(d, copy=True)
                              for f in _FIELDS))
                 for k, d in enumerate(mesh.flat))


def gather_batch(shards: BatchShards, device=None) -> FluidState:
    """The whole batch from its slices, on ``device`` (default the first
    slice's): the counterpart of np.asarray on a batch-sharded JAX array."""
    device = shards[0].velocity.device if device is None else torch.device(device)
    return FluidState(*(torch.cat([getattr(s, f).to(device) for s in shards])
                        for f in _FIELDS))


def check_batch_shards(shards: BatchShards, mesh: Mesh, per_slice: int) -> None:
    """Raises unless ``shards`` is a batch-sharded state on ``mesh``: one
    batched slice of ``per_slice`` sims a mesh device, each on its device."""
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} batch slices on a mesh of {mesh.size} devices")
    for k, (s, d) in enumerate(zip(shards, mesh.flat)):
        if s.velocity.ndim != 4 or s.velocity.shape[0] != per_slice or s.velocity.device != d:
            raise ValueError(f"batch slice {k}: velocity {tuple(s.velocity.shape)} on "
                             f"{s.velocity.device}, the mesh puts ({per_slice}, 2, H, W) on {d}")


def make_batch_sharded_multi_step(config: FluidConfig, mesh: Mesh):
    """multi(batch_shards, dt, splats_seq) -> batch_shards with the batch
    axis sharded over ``mesh`` (shard_batch's layout): each device runs T
    batched steps (make_batched_multi_step's body) on its own B / n sims,
    with its rows of ``splats_seq`` (T, B, MAX_SPLATS, 8) and, for a (T, B)
    per-sim ``dt``, its columns as one dt table, each copied to its device
    once a call; a scalar or (T,) dt is lock-step. No byte moves between
    devices, every output slice stays on its input's device, and each sim
    equals the unsharded batched step's bit for bit. Raises ValueError where
    mesh.size does not divide B, and for a (B,) dt."""

    def multi(shards: BatchShards, dt, splats_seq) -> BatchShards:
        seq = torch.as_tensor(splats_seq, dtype=torch.float32)
        if seq.ndim != 4:
            raise ValueError(f"splats_seq {tuple(seq.shape)}, expected (T, B, S, 8)")
        t, b = seq.shape[:2]
        m = _split(b, mesh.size, "mesh size")
        dts = _multi_dts(dt, t, b)
        check_batch_shards(shards, mesh, m)
        devices = mesh.flat
        seqs = [seq[:, k * m:(k + 1) * m].to(d) for k, d in enumerate(devices)]
        tables = [_slice_dts(dts, k * m, (k + 1) * m, config, d) for k, d in enumerate(devices)]
        out = list(shards)
        # Step-major, so that each step is enqueued on every device before
        # the next: the devices of a multi-card mesh run side by side.
        for i in range(t):
            for k in range(len(out)):
                out[k] = _step(out[k], tables[k][i], seqs[k][i], config, dispatch.ROUTED)
        return tuple(out)

    return multi


# ---------------------------------------------------------------------------
# Batch x spatial: a group of sims a (ny, nx) sub-mesh.
# ---------------------------------------------------------------------------

BATCH_AXIS = "b"


@dataclasses.dataclass(frozen=True)
class BatchSpatialMesh:
    """An (nb, ny, nx) mesh over axes ('b', 'y', 'x'): ``groups`` holds nb
    (ny, nx) Meshes over (rows, columns), group g's sims sharded on its
    own devices. All CPU or all CUDA."""

    groups: Tuple[Mesh, ...]
    axis_names: Tuple[str, str, str] = (BATCH_AXIS, ROW_AXIS, COL_AXIS)

    def __post_init__(self):
        if not self.groups or len({g.shape for g in self.groups}) != 1:
            raise ValueError("a batch x spatial mesh is nb >= 1 groups of one (ny, nx) shape")
        if len({d.type for g in self.groups for d in g.flat}) != 1:
            raise ValueError("a mesh's devices are all CPU or all CUDA")

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (len(self.groups),) + self.groups[0].shape

    @property
    def size(self) -> int:
        return len(self.groups) * self.groups[0].size


def make_batch_spatial_mesh(shape, devices: Optional[Sequence] = None) -> BatchSpatialMesh:
    """The (nb, ny, nx) mesh of the combined mode: batch DP over 'b' and each
    group's grids sharded over ('y', 'x'), the first nb * ny * nx of
    ``devices`` in row-major order (default every visible CUDA device;
    raises without a GPU, or with too few devices)."""
    nb, ny, nx = (int(x) for x in shape)
    n = nb * ny * nx
    if devices is None:
        devices = make_mesh().flat
    devices = list(devices)
    if len(devices) < n:
        raise ValueError(f"{len(devices)} devices for a ({nb}, {ny}, {nx}) mesh of {n}")
    k = ny * nx
    return BatchSpatialMesh(tuple(make_mesh(devices=devices[g * k:(g + 1) * k], shape=(ny, nx))
                                  for g in range(nb)))


# A batch x spatial state: nb sharded states, group g's shards each holding
# its B / nb sims' (rows, columns) block, batch axis leading.
BatchSpatialState = Tuple[ShardedState, ...]


def shard_batch_spatial(state: FluidState, mesh: BatchSpatialMesh) -> BatchSpatialState:
    """Split a batched state over an (nb, ny, nx) mesh: B / nb consecutive
    sims a group, each group's fields cut into its (ny, nx) blocks
    (mesh.shard_state), each block copied to its device."""
    m = _split(state.velocity.shape[0], len(mesh.groups), "mesh batch axis")
    return tuple(shard_state(FluidState(*(getattr(state, f)[g * m:(g + 1) * m]
                                          for f in _FIELDS)), group)
                 for g, group in enumerate(mesh.groups))


def gather_batch_spatial(shards: BatchSpatialState, device=None) -> FluidState:
    """The whole batch from its groups' shards, on ``device`` (default the
    first shard's)."""
    device = shards[0][0][0].velocity.device if device is None else torch.device(device)
    groups = [gather_state(g, device) for g in shards]
    return FluidState(*(torch.cat([getattr(g, f) for g in groups]) for f in _FIELDS))


def make_batch_spatial_multi_step(config: FluidConfig, mesh: BatchSpatialMesh,
                                  plain: bool = False):
    """multi(batch_spatial_state, dt, splats_seq) -> batch_spatial_state over
    an (nb, ny, nx) mesh (shard_batch_spatial's layout): group g runs T
    sharded steps (parallel/sharded_step.py) of its B / nb sims, each
    launch taking all of them, with its rows of ``splats_seq`` (T, B,
    MAX_SPLATS, 8) and, for a (T, B) per-sim ``dt``, its columns as one dt
    table a device of the group; a scalar or (T,) dt is lock-step. A
    group's halos stay within its own sharded state, so groups never read
    each other's fields; each sim equals its single-sim sharded step on its
    group's (ny, nx) mesh, bit for bit. ``plain`` runs the kernels' plain
    versions on any device (the reference the kernel passes are held to).

    Raises ValueError at construction where the grid extents do not divide
    (ny, nx) ("must divide"), and per call where nb does not divide B ("not
    divisible") or for a (B,) dt."""
    nb, ny, nx = mesh.shape
    sw, sh = config.sim_size
    dw, dh = config.dye_size
    if sh % ny or dh % ny or sw % nx or dw % nx:
        raise ValueError(f"grid extents {(sh, sw)}/{(dh, dw)} must divide mesh spatial shape "
                         f"{(ny, nx)}")
    passes = dispatch.PLAIN if plain else dispatch.ROUTED

    def multi(state: BatchSpatialState, dt, splats_seq) -> BatchSpatialState:
        seq = torch.as_tensor(splats_seq, dtype=torch.float32)
        if seq.ndim != 4:
            raise ValueError(f"splats_seq {tuple(seq.shape)}, expected (T, B, S, 8)")
        t, b = seq.shape[:2]
        m = _split(b, nb, "mesh batch axis")
        dts = _multi_dts(dt, t, b)
        if len(state) != nb:
            raise ValueError(f"{len(state)} groups of shards on a mesh of {nb}")
        for shards, group in zip(state, mesh.groups):
            _sharded._check_shards(shards, group)
            if any(s.velocity.ndim != 4 or s.velocity.shape[0] != m for r in shards for s in r):
                raise ValueError(f"a group's shards must each hold its {m} sims, (B, 2, h, w)")
        out = list(state)
        groups = []
        for g, group in enumerate(mesh.groups):
            lo, hi = g * m, (g + 1) * m
            devices = set(group.flat)
            seqs = {d: seq[:, lo:hi].to(d) for d in devices}
            tables = {d: _slice_dts(dts, lo, hi, config, d) for d in devices}
            groups.append((seqs, tables))
        for i in range(t):
            for g, (seqs, tables) in enumerate(groups):
                step_dt = ({d: tab[i] for d, tab in tables.items()}
                           if isinstance(dts, np.ndarray) else dts[i])
                out[g] = _sharded._step(out[g], step_dt, {d: s[i] for d, s in seqs.items()},
                                        config, passes)
        return tuple(out)

    return multi
