"""Long-horizon stability / energy-decay run of the port.

The counterpart of tools/long_horizon.py, with its arguments, summary keys
and ``ok`` rule. Runs the full fluid step for --steps steps (splat input for
the first --splat-steps, then free decay) in chunks of --chunk steps through
make_multi_step, logging diagnostics after every chunk, and writes:

  <out>/metrics.jsonl   one diagnostics record per chunk
  <out>/summary.json    the stability claims, checked: nonfinite == 0
      throughout; backtrace_speed inside halo_contract_speed; kinetic energy
      after the input stops falling below a quarter, with upticks under 10%
      per chunk (vorticity confinement is an anti-dissipation term, so the
      decay is not monotone); div_rms bounded. max_component_speed is
      reported, not asserted at 1000: the reference's +/-1000 clamp applies
      before the projection, whose gradient kick is never re-clamped.

On the GPU by default; --cpu runs the plain versions on the CPU.

  python -m tpufluid_torch.tools.long_horizon --res 4096 --dtype bfloat16 \\
      --out out/long_horizon_4096
  python -m tpufluid_torch.tools.long_horizon --cpu --res 64 --steps 200
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from tpufluid_torch import FluidConfig, init_state, make_multi_step, swirl_trace
from tpufluid_torch.metrics import MetricsLogger, contract_warning


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--res", type=int, default=512)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--steps", type=int, default=5000)
    p.add_argument("--splat-steps", type=int, default=500)
    p.add_argument("--chunk", type=int, default=50)
    p.add_argument("--jacobi-iters", type=int, default=20)
    p.add_argument("--out", default="out/long_horizon")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain versions on the CPU instead of the GPU")
    args = p.parse_args(argv)

    device = torch.device("cpu" if args.cpu else "cuda")
    cfg = FluidConfig(SIM_RESOLUTION=args.res, DYE_RESOLUTION=args.res,
                      CANVAS_WIDTH=args.res, CANVAS_HEIGHT=args.res,
                      PRESSURE_ITERATIONS=args.jacobi_iters,
                      DTYPE=args.dtype, MAX_SPLATS=8).validate()
    os.makedirs(args.out, exist_ok=True)
    multi = make_multi_step(cfg, device=device)
    state = init_state(cfg, device=device)
    trace = swirl_trace(cfg, args.splat_steps, seed=11)
    batches = torch.as_tensor(np.asarray(trace.batches, np.float32), device=device)
    none_batch = torch.zeros((args.chunk,) + tuple(batches.shape[1:]), device=device)
    dt = float(np.float32(1.0 / 60.0))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    logger = MetricsLogger(os.path.join(args.out, "metrics.jsonl"))
    records = []
    t0 = time.time()
    step = 0
    warned = 0
    # compute_s: each chunk's steps, closed by a device synchronize;
    # diagnostics_s: the logger's diagnostics and their host transfer.
    compute_s = 0.0
    diag_s = 0.0
    chunk_secs = []  # per-chunk compute (chunk 0 carries the kernels' build)
    while step < args.steps:
        n = min(args.chunk, args.steps - step)
        if step < args.splat_steps:
            chunk = batches[step:step + n]
            if len(chunk) < n:  # input tail shorter than the chunk
                chunk = torch.cat([chunk, none_batch[:n - len(chunk)]])
        else:
            chunk = none_batch[:n]
        ta = time.time()
        state = multi(state, dt, chunk)
        sync()
        tb = time.time()
        step += n
        rec = logger.log(step, state, cfg)
        diag_s += time.time() - tb
        compute_s += tb - ta
        chunk_secs.append(tb - ta)
        records.append(rec)
        if contract_warning(rec):
            warned += 1
        if step % (args.chunk * 10) == 0 or step == args.steps:
            print(f"step {step}/{args.steps}: max|v|={rec['max_speed']:.1f} "
                  f"E={rec['kinetic_energy']:.4g} div_rms={rec['div_rms']:.3g} "
                  f"nonfinite={rec['nonfinite']:.0f}", flush=True)
    elapsed = time.time() - t0
    logger.close()

    # ---- the stability claims ----
    post = [r for r in records if r["step"] > args.splat_steps]
    energies = [r["kinetic_energy"] for r in post]
    upticks = [max(0.0, b - a) / max(a, 1e-9)
               for a, b in zip(energies, energies[1:])]
    summary = {
        "config": {"res": args.res, "dtype": args.dtype, "steps": args.steps,
                   "splat_steps": args.splat_steps,
                   "jacobi_iters": args.jacobi_iters},
        "steps_per_s": round(args.steps / elapsed, 2),
        # The median chunk's compute rate: the steady state, without the
        # first chunk (which builds and loads the kernels).
        "steps_per_s_compute_median": round(
            args.chunk / float(np.median(chunk_secs[1:] or chunk_secs)), 2),
        "steps_per_s_compute": round(args.steps / max(compute_s, 1e-9), 2),
        "compute_seconds": round(compute_s, 2),
        "first_chunk_seconds": round(chunk_secs[0], 2),
        # Last over first quartile of the chunk times: how far the step
        # rate drifts as the run ages (the key name is the JAX tool's).
        "tunnel_decay_x": round(
            float(np.mean(chunk_secs[-max(1, len(chunk_secs) // 4):])
                  / max(np.mean(chunk_secs[1:1 + max(1, len(chunk_secs)
                                                     // 4)]), 1e-9)), 2)
        if len(chunk_secs) > 2 else None,
        "diagnostics_seconds": round(diag_s, 2),
        "rate_accounting": ("wall = first chunk (kernel build and load, "
                            "first_chunk_seconds) + chunk compute (each chunk "
                            "closed by a device synchronize) + per-chunk "
                            "diagnostics (diagnostics_seconds); tunnel_decay_x "
                            "= last/first quartile of the chunk times"),
        "nonfinite_total": sum(r["nonfinite"] for r in records),
        "max_component_speed_peak": max(r["max_component_speed"]
                                        for r in records),
        "backtrace_speed_peak": max(r["backtrace_speed"] for r in records),
        "halo_contract_speed": records[-1]["halo_contract_speed"],
        "contract_warnings": warned,
        "energy_at_input_stop": energies[0] if energies else None,
        "energy_final": energies[-1] if energies else None,
        "energy_decay_ratio": (energies[-1] / energies[0]
                               if energies and energies[0] else None),
        "energy_max_uptick_frac": max(upticks) if upticks else 0.0,
        "div_rms_final": records[-1]["div_rms"],
        "div_rms_peak": max(r["div_rms"] for r in records),
        "dye_max_final": records[-1]["dye_max"],
    }
    # No post-input records (--steps <= --splat-steps) leave the decay claim
    # unverifiable: not ok, and summary.json is still written.
    decayed = (summary["energy_final"] is not None
               and summary["energy_at_input_stop"]
               and summary["energy_final"]
               < 0.25 * summary["energy_at_input_stop"])
    summary["ok"] = bool(
        summary["nonfinite_total"] == 0
        and summary["backtrace_speed_peak"]
        <= summary["halo_contract_speed"]
        and decayed
        and summary["energy_max_uptick_frac"] < 0.10)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
