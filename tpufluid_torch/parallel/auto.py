"""The auto-sharded step: the port's counterpart of tpufluid/parallel/auto.py.

JAX's baseline annotates the state's shardings, jits the single-device
step and lets GSPMD partition every op and insert the collectives. PyTorch
has no partitioner that splits one process's ops over a mesh so: DTensor
needs a process group with one rank a device, and the port drives its mesh
from one process (mesh.py). So this baseline gathers the shards to the
mesh's first device (``gather_state``), runs ``fluid_step`` there (the CUDA
kernels on a CUDA mesh, their plain versions on a CPU one) and cuts the
result back into the mesh's blocks (``shard_state``). JAX turns its
kernels off here only because Pallas calls do not auto-partition
(tpufluid/parallel/auto.py:25-26); the port's step has no such limit.

It is the correctness baseline that tests/test_sharding.py:396
(test_auto_sharded_step_matches_single_device) uses JAX's for: every step
equals make_step's on the gathered state, bit for bit. It is not a path
that scales: one device does all the work and every step moves the whole
state twice.
"""

from __future__ import annotations

from tpufluid_torch.config import FluidConfig
from tpufluid_torch.parallel.mesh import Mesh, ShardedState, gather_state, make_mesh, shard_state
from tpufluid_torch.parallel.sharded_step import _check_shards
from tpufluid_torch.step import fluid_step


def make_auto_sharded_step(config: FluidConfig, mesh: Mesh = None):
    """step(shards, dt, splats) -> shards over ``mesh`` (default make_mesh():
    every visible GPU as rows; raises without one): the whole state
    gathered to the mesh's first device, one fluid_step there, the result
    sharded again. Any grid the mesh divides."""
    mesh = make_mesh() if mesh is None else mesh
    first = mesh.devices[0][0]

    def step(shards: ShardedState, dt, splats) -> ShardedState:
        _check_shards(shards, mesh)
        return shard_state(fluid_step(gather_state(shards, first), dt, splats, config), mesh)

    return step
