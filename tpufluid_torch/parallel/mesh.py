"""The mesh of devices and the sharded state, for one controlling process.

Counterpart of tpufluid/parallel/mesh.py. JAX's ``shard_map`` is one process
driving every device of a mesh; so is the port: a mesh is a (ny, nx) grid of
``torch.device``, grid rows (H / ny) over its axis ROW_AXIS and columns
(W / nx) over COL_AXIS, and a sharded state is the (ny, nx) grid of each
shard's FluidState, each on its own device. A device may appear more than
once (its shards then run one after another): the tests put 8 shards on the
CPU, as the JAX tests put them on 8 virtual CPU devices, and one card can
hold a 2x2 mesh. A mesh is of one device type, CPU or CUDA, never both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from tpufluid_torch.state import FluidState

ROW_AXIS = "y"
COL_AXIS = "x"

# The (ny, nx) grid of every shard's state, row-major: sharded[i][j] holds
# grid rows i * H / ny ... and columns j * W / nx ... on mesh.devices[i][j].
ShardedState = Tuple[Tuple[FluidState, ...], ...]


def _device(d) -> torch.device:
    """``d`` as a torch.device, a CUDA device with its index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class Mesh:
    """(ny, nx) devices over (rows, columns); ``axis_names`` as JAX's."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = (ROW_AXIS, COL_AXIS)

    def __post_init__(self):
        rows = tuple(tuple(_device(d) for d in row) for row in self.devices)
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty (ny, nx) grid of devices")
        types = {d.type for r in rows for d in r}
        if len(types) != 1 or types - {"cpu", "cuda"}:
            raise ValueError(f"a mesh's devices are all CPU or all CUDA, got {sorted(types)}")
        object.__setattr__(self, "devices", rows)

    @property
    def shape(self) -> Tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def flat(self) -> Tuple[torch.device, ...]:
        """The devices in row-major order: the order batch DP's slices take."""
        return tuple(d for row in self.devices for d in row)


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None,
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """A (ny, nx) mesh over (rows, columns), by default every visible CUDA
    device as a 1-D row decomposition (n, 1). Raises without a GPU unless
    ``devices`` are given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() takes the visible CUDA devices and there is none; "
                               "pass devices=[...] (e.g. ['cpu'] * 8) for a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    devices = list(devices)
    ny, nx = (len(devices), 1) if shape is None else tuple(shape)
    if ny * nx != len(devices):
        raise ValueError(f"{len(devices)} devices do not make a ({ny}, {nx}) mesh")
    return Mesh(tuple(tuple(devices[i * nx:(i + 1) * nx]) for i in range(ny)))


def shard_state(state: FluidState, mesh: Mesh) -> ShardedState:
    """Cut a state into the mesh's (rows, columns) blocks, each copied to
    its device. Extents must divide the mesh axes."""
    ny, nx = mesh.shape
    for f in (state.velocity, state.dye, state.pressure):
        h, w = f.shape[-2:]
        if h % ny or w % nx:
            raise ValueError(f"field {tuple(f.shape)} does not divide mesh {(ny, nx)}")

    def block(f, i, j):
        h, w = f.shape[-2] // ny, f.shape[-1] // nx
        return f[..., i * h:(i + 1) * h, j * w:(j + 1) * w].to(mesh.devices[i][j]).contiguous()

    return tuple(tuple(FluidState(*(block(f, i, j) for f in (state.velocity, state.dye,
                                                               state.pressure)))
                       for j in range(nx)) for i in range(ny))


def gather_state(sharded: ShardedState, device=None) -> FluidState:
    """The whole state from its shards, on ``device`` (default the first
    shard's): the counterpart of np.asarray on a sharded JAX array."""
    device = sharded[0][0].velocity.device if device is None else torch.device(device)

    def field(name):
        return torch.cat([torch.cat([getattr(s, name).to(device) for s in row], dim=-1)
                          for row in sharded], dim=-2)

    return FluidState(field("velocity"), field("dye"), field("pressure"))
