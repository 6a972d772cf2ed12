"""How far the batch x spatial (sharded) step departs from the unsharded step,
sim by sim and step by step.

The sharded step is not bit-equal to the unsharded one: a padded block
rounds its backtrace coordinates otherwise than the whole grid
(parallel/sharded_step.py), and the chaos of the flow amplifies the
difference. Each sim of make_batch_spatial_multi_step equals its single-sim
sharded step bit for bit, so this measures the sharded step's own departure
on each sim's trace. B = 2 nb sims, sim i driven by swirl_trace(seed
--seed + i), with per-sim dts linspace(1/90, 1/60) or one --dt for all;
after each step it prints, for every sim, each field's largest difference
over the sim's own scale and over the batch's, and where the worst sim's
largest dye difference lies (row, column, and its distance from the nearest
shard edge: a halo fault shows at an edge, rounding noise anywhere).

  TPUFLUID_DEVICE=cpu python -m tpufluid_torch.tools.sharded_departure \\
      --grid demo --dtype float32 --mesh 2x2x2 --steps 4
  python -m tpufluid_torch.tools.sharded_departure --grid demo --mesh 4x2x2 --dt 0.0166667
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tpufluid_torch import (FluidConfig, gather_batch_spatial, init_batch,
                            make_batch_spatial_mesh, make_batch_spatial_multi_step,
                            make_batched_multi_step, shard_batch_spatial, swirl_trace)
from tpufluid_torch.state import device_from_env

GRIDS = {"demo": dict(SIM_RESOLUTION=128, DYE_RESOLUTION=1024, CANVAS_WIDTH=1280,
                      CANVAS_HEIGHT=720),
         "split": dict(SIM_RESOLUTION=256, DYE_RESOLUTION=512, CANVAS_WIDTH=256,
                       CANVAS_HEIGHT=256, OVERLAP_HALO=True)}
FIELDS = ("velocity", "dye", "pressure")


def run(grid: str, dtype: str, mesh_shape, steps: int, seed: int, dt, device) -> list:
    """One record a step: per sim and field, the departure over the sim's
    own scale and over the batch's; the worst dye texel's place."""
    cfg = FluidConfig(DTYPE=dtype, PRESSURE_ITERATIONS=20, MAX_SPLATS=8,
                      **GRIDS[grid]).validate()
    nb, ny, nx = mesh_shape
    b = 2 * nb
    n_dev = nb * ny * nx
    devices = [device] * n_dev if device.type == "cpu" else [
        f"cuda:{k % torch.cuda.device_count()}" for k in range(n_dev)]
    mesh = make_batch_spatial_mesh(mesh_shape, devices)
    seq = np.stack([swirl_trace(cfg, steps, seed=seed + i).batches for i in range(b)], axis=1)
    dts = (np.broadcast_to(np.linspace(1 / 90, 1 / 60, b, dtype=np.float32), (steps, b))
           if dt is None else np.full((steps, b), dt, np.float32))
    sharded = make_batch_spatial_multi_step(cfg, mesh)
    whole = make_batched_multi_step(cfg, device=device)
    a = shard_batch_spatial(init_batch(cfg, b, device=device), mesh)
    u = init_batch(cfg, b, device=device)
    records = []
    for t in range(steps):
        a = sharded(a, dts[t:t + 1], seq[t:t + 1])
        u = whole(u, dts[t:t + 1], seq[t:t + 1])
        g = gather_batch_spatial(a, device)
        rec = {"step": t + 1, "sims": []}
        batch_scale = {f: max(float(getattr(u, f).float().abs().max()), 1e-3) for f in FIELDS}
        worst = (-1.0, None)
        for i in range(b):
            sim = {}
            for f in FIELDS:
                x, y = getattr(g, f)[i].float(), getattr(u, f)[i].float()
                diff = (x - y).abs()
                err = float(diff.max())
                own = err / max(float(y.abs().max()), 1e-3)
                sim[f] = (own, err / batch_scale[f])
                if f == "dye" and own > worst[0]:
                    worst = (own, (i, np.unravel_index(int(diff.argmax()), diff.shape)))
            rec["sims"].append(sim)
        i, (c, r, col) = worst[1]
        hd, wd = cfg.dye_size[1] // ny, cfg.dye_size[0] // nx
        edge = min(r % hd, hd - 1 - r % hd, col % wd, wd - 1 - col % wd)
        rec["worst_dye"] = {"sim": i, "channel": int(c), "row": int(r), "col": int(col),
                            "texels_from_shard_edge": int(edge)}
        records.append(rec)
    return records


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--grid", choices=sorted(GRIDS), default="demo")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--mesh", default="2x2x2", help="nb x ny x nx")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--dt", type=float, default=None,
                   help="one dt for every sim (default: linspace(1/90, 1/60) a sim)")
    args = p.parse_args(argv)
    shape = tuple(int(x) for x in args.mesh.split("x"))
    records = run(args.grid, args.dtype, shape, args.steps, args.seed, args.dt,
                  device_from_env())
    for rec in records:
        print(f"step {rec['step']}: " + "; ".join(
            f"sim {i} (seed {args.seed + i}) " + " ".join(
                f"{f} {own:.2e}/{bat:.2e}" for f, (own, bat) in sim.items())
            for i, sim in enumerate(rec["sims"])) + f"; worst dye texel {rec['worst_dye']}")
    return records


if __name__ == "__main__":
    main()
