"""tpufluid_torch.parallel: the sharded step over a mesh of devices.

Counterpart of tpufluid/parallel (its ``halo`` path): the grids are cut
into (rows, columns) blocks over a (ny, nx) mesh of devices and every phase
of the step exchanges the ghost rows and columns it reaches before it runs
the step's own passes on each shard's padded block. One process drives
every device, as JAX's ``shard_map`` does (mesh.py). ``auto`` is the
counterpart of ``tpufluid.parallel.auto`` (GSPMD over the plain step): the
shards gathered to one device, the single-device step there, the result
sharded again; a correctness baseline, not a path that scales.
"""

from tpufluid_torch.parallel.halo import exchange_halo_rows
from tpufluid_torch.parallel.mesh import gather_state, make_mesh, shard_state
from tpufluid_torch.parallel.sharded_step import (make_sharded_multi_step, make_sharded_step,
                                                  sharded_fluid_step)
from tpufluid_torch.parallel.auto import make_auto_sharded_step
