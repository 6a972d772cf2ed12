"""Time the Jacobi chunk kernel at each candidate number of sweeps a launch.

    python -m tpufluid_torch.tools.kernel_candidates [--iters 20] [--json PATH]

On 1024x1024 bfloat16 and the demo's 128x228 float32 (pressure and
divergence from numpy, seed 0), a solve of ``--iters`` sweeps cut into
launches of K = 1, 4, 5, 8, 10 and 20 sweeps (where the grid's tiles,
ops/cuda/jacobi.py tiles_for, leave room for a K-deep halo). Every candidate
must equal jacobi_plain bit for bit. Prints one line per candidate: its
device ms (spin-queued CUDA events, as chip_smoke.py times), launches, the
cell-sweeps it computes over the function's, and the card's name and power
limit; ``--json`` writes the rows.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from tpufluid_torch.ops.cuda import jacobi
from tpufluid_torch.ops.cuda.floors import queued_ms, spin_rate

GRIDS = (("1024_bfloat16", 1024, 1024, torch.bfloat16),
         ("demo_float32", 128, 228, torch.float32))
SWEEPS = (1, 4, 5, 8, 10, 20)


def jacobi_rows(iters: int, rate: float, gpu: str) -> list:
    rng = np.random.default_rng(0)
    sms = jacobi.sm_count(torch.device("cuda"))
    rows = []
    for name, h, w, dtype in GRIDS:
        p = torch.from_numpy(rng.standard_normal((h, w), dtype=np.float32)).cuda().to(dtype)
        d = torch.from_numpy(rng.standard_normal((h, w), dtype=np.float32)).cuda().to(dtype)
        want = jacobi.jacobi_plain(p, d, iters, 0.8).float()
        t = jacobi.TILES[jacobi.tiles_for(h, w, sms)]
        for k in SWEEPS:
            if k > min(t.max_sweeps(), iters):
                continue
            cut = jacobi.chunks(iters, k)
            err = float((jacobi.run_chunks(p, d, 0.8, cut).float() - want).abs().max())
            ms = queued_ms(lambda: jacobi.run_chunks(p, d, 0.8, cut), 20, rate)
            design = sum(t.blocks(h, w, kk) * t.rh * t.rw * kk for kk in cut)
            row = {"kernel": "jacobi_chunk", "grid": name, "rw": t.rw, "rh": t.rh,
                   "threads": t.rw * t.ny, "rows_a_thread": t.r, "min_blocks": t.min_blocks,
                   "sweeps_a_launch": k, "launches": len(cut), "ms": ms,
                   "overcompute": design / (h * w * iters), "max_abs_err": err}
            rows.append(row)
            print(f"jacobi candidate {name:14s} ({t.rh}x{t.rw} region, {t.rw * t.ny} threads, "
                  f"{t.r} rows a thread, {t.min_blocks} a SM) K={k:2d} launches "
                  f"{len(cut):2d}: {ms:.4f} ms, overcompute {row['overcompute']:.3f}, "
                  f"max_abs_err {err:.1e} on {gpu}", flush=True)
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_candidates measures a CUDA GPU and none is available")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    rows = jacobi_rows(args.iters, spin_rate(), gpu)
    sms = jacobi.sm_count(torch.device("cuda"))
    chosen = {name: jacobi.plan(h, w, args.iters, sms) for name, h, w, _ in GRIDS}
    print(f"jacobi plan on {sms} SMs: {chosen}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"gpu": gpu, "rows": rows, "jacobi_plan": chosen}, f, indent=1)
    bad = [r for r in rows if r["max_abs_err"] != 0.0]
    if bad:
        raise AssertionError(f"candidates that differ from jacobi_plain: {bad}")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
