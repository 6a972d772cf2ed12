"""Fidelity drift curves of the port: 16-bit storage modes against the f32
truth over time.

The counterpart of tools/fidelity_drift.py, with its five variants, step
count, record interval, grid, trace seed and summary keys: over hundreds of
chaotic steps, do the 16-bit modes drift from the f32 truth like precision
noise (the decorrelation any 1-ulp perturbation suffers) or like a
systematic bias (energy drain, extra diffusion)?

The same seeded trace (swirl_trace seed 42) advances in five variants
through the port's step, the CUDA kernels on the GPU (their plain versions
with TPUFLUID_DEVICE=cpu):

  * f32          - the truth;
  * f32_eps      - f32 with a one-time 1e-6 relative velocity perturbation
                   at step 50 (once the flow is nonzero): the butterfly
                   baseline. Its noise comes from a torch.Generator seeded
                   0, not from the JAX tool's PRNGKey(0), so only the
                   statistics of the two tools compare, not their numbers;
  * bf16_rgb9e5  - bfloat16 with the RGB9E5 dye gather (the default);
  * bf16_plain   - bfloat16, DYE_RGB9E5=False;
  * f16          - IEEE half storage.

Every RECORD_EVERY steps: the relative L2 error of the velocity and the dye
against the truth, and the signed relative difference of kinetic energy and
dye mass (integral quantities track the truth unless a mode adds real
diffusion).

Writes out/fidelity_drift_torch/{drift.jsonl,summary.json} (the JAX tool's
out/fidelity_drift/ is left alone).

  python -m tpufluid_torch.tools.fidelity_drift
  TPUFLUID_DEVICE=cpu python -m tpufluid_torch.tools.fidelity_drift --steps 40 --sim 32
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

from tpufluid_torch import FluidConfig, init_state, make_step, swirl_trace
from tpufluid_torch.state import FluidState, device_from_env, resolve_device

OUT = pathlib.Path(__file__).resolve().parents[2] / "out" / "fidelity_drift_torch"
STEPS = 400
RECORD_EVERY = 10
SIM, DYE = 256, 256
PERTURB_AT = 50
TRACE_SEED = 42


def run_variant(cfg: FluidConfig, trace, steps: int, device, perturb_at=None) -> dict:
    """{step: {"velocity", "dye"}} float32 numpy snapshots every
    RECORD_EVERY steps of ``steps`` steps of ``trace``; ``perturb_at``:
    multiply the velocity by 1 + 1e-6 N(0, 1) (a generator seeded 0) before
    that step."""
    step = make_step(cfg, device=device)
    s = init_state(cfg, device=device)
    out = {}
    for t in range(steps):
        if t == perturb_at:
            gen = torch.Generator().manual_seed(0)
            noise = 1.0 + 1e-6 * torch.randn(tuple(s.velocity.shape), generator=gen)
            s = FluidState(velocity=(s.velocity.to(torch.float32) * noise.to(device)
                                     ).to(cfg.dtype), dye=s.dye, pressure=s.pressure)
        s = step(s, trace.dt, trace.batches[t])
        if (t + 1) % RECORD_EVERY == 0:
            out[t + 1] = {f: getattr(s, f).to("cpu", torch.float32).numpy()
                          for f in ("velocity", "dye")}
    return out


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    denom = float(np.linalg.norm(b.ravel())) or 1.0
    return float(np.linalg.norm((a - b).ravel())) / denom


def run(steps: int = STEPS, sim: int = SIM, dye: int = DYE, device="cuda",
        records: list = None) -> dict:
    """Each variant's summary, under the JAX tool's keys; ``records``, where
    given, gains one record a variant and record step. ``vel_rel_l2_at_100``
    is read at step 100, or at the last record of a shorter run."""
    device = resolve_device(device)
    base = dict(SIM_RESOLUTION=sim, DYE_RESOLUTION=dye, CANVAS_WIDTH=dye, CANVAS_HEIGHT=dye,
                MAX_SPLATS=8)
    cfg32 = FluidConfig(DTYPE="float32", **base).validate()
    trace = swirl_trace(cfg32, steps, seed=TRACE_SEED)
    variants = {
        "f32_eps": (cfg32, PERTURB_AT),
        "bf16_rgb9e5": (FluidConfig(DTYPE="bfloat16", **base).validate(), None),
        "bf16_plain": (FluidConfig(DTYPE="bfloat16", DYE_RGB9E5=False, **base).validate(),
                       None),
        "f16": (FluidConfig(DTYPE="float16", **base).validate(), None),
    }
    truth = run_variant(cfg32, trace, steps, device)
    at_100 = 100 if 100 in truth else max(truth)
    records = [] if records is None else records
    summary = {}
    for name, (cfg, perturb) in variants.items():
        snaps = run_variant(cfg, trace, steps, device, perturb)
        rows = []
        for t, ref in truth.items():
            got = snaps[t]
            ke_ref = float(np.sum(ref["velocity"].astype(np.float64) ** 2))
            ke_got = float(np.sum(got["velocity"].astype(np.float64) ** 2))
            dm_ref = float(np.sum(ref["dye"].astype(np.float64))) or 1.0
            dm_got = float(np.sum(got["dye"].astype(np.float64)))
            rows.append(dict(
                variant=name, step=t,
                vel_rel_l2=round(rel_l2(got["velocity"], ref["velocity"]), 6),
                dye_rel_l2=round(rel_l2(got["dye"], ref["dye"]), 6),
                ke_rel_diff=round((ke_got - ke_ref) / (ke_ref or 1.0), 6),
                dye_mass_rel_diff=round((dm_got - dm_ref) / dm_ref, 6),
            ))
        records += rows
        summary[name] = dict(
            final=rows[-1],
            vel_rel_l2_at_100=next(r["vel_rel_l2"] for r in rows if r["step"] == at_100),
            max_abs_ke_rel_diff=max(abs(r["ke_rel_diff"]) for r in rows),
            max_abs_dye_mass_rel_diff=max(abs(r["dye_mass_rel_diff"]) for r in rows),
        )
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--sim", type=int, default=SIM)
    p.add_argument("--dye", type=int, default=DYE)
    p.add_argument("--out", default=str(OUT))
    args = p.parse_args(argv)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    records = []
    summary = run(args.steps, args.sim, args.dye, device_from_env(), records=records)
    for name, s in summary.items():
        print(name, json.dumps(s))
    with open(out / "drift.jsonl", "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    with open(out / "summary.json", "w") as f:
        json.dump(dict(steps=args.steps, record_every=RECORD_EVERY, sim=args.sim, dye=args.dye,
                       trace_seed=TRACE_SEED, variants=summary), f, indent=1)
    print("wrote", out)
    return summary


if __name__ == "__main__":
    main()
