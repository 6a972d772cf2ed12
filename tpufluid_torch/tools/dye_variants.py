"""Time variants of the dye kernel's design constants on the card.

    python3 tpufluid_torch/tools/dye_variants.py [--variants base,lb4,...]

Run from the checkout's root. Each variant is csrc/advect.cu with some of
advect_dye_kernel's constants changed (its tile, threads a block, shared
memory budget, the blocks an SM its launch bounds ask for, the texels a
staging thread loads at once) or one of its phases knocked out ("nostage":
no window texel is prepared; "nogather": no target texel is gathered).
Every variant is copied with the checkout's tpufluid_torch into
tpufluid_torch/_build/dye_variants/<name>/ and built there, all nvcc
processes at once. Then, one process a variant, advect:dye
(check.step_cases) is timed at the demo (f32), 1024x1024 (bf16, RGB9E5)
and 64 sims of 288^2 (bf16, RGB9E5, batched), each on check.random_state /
random_batch (seed 7) and on the flow state after 100 swirl_trace steps
through make_multi_step / make_batched_multi_step (seed 42, sim i 42 + i),
computed once by the checkout itself. Each time is 20 calls queued behind
a spin kernel, the median of 3. A line a (variant, cell, state):

    DV <variant> <cell> <random|flow> ms <ms> err <max abs err> fit <share> box/tile <ratio>

err is against advect_plain (0 for every variant that computes the
function; the knockouts do not), fit the share of tiles whose window fits
the budget and box/tile the mean window texels over a tile's texels
(advect.dye_window_plan with the variant's tile and budget).
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "tpufluid_torch" / "_build" / "dye_variants"
BASE = dict(tile_w=32, tile_h=32, threads_y=8, smem_kb=24, min_blocks=4, stage=4, knockout="")
VARIANTS = {
    "base": {},
    "smem48_lb3": dict(smem_kb=48, min_blocks=3),
    "smem48_lb4": dict(smem_kb=48),
    "stage8": dict(stage=8),
    "tile64x16": dict(tile_w=64, tile_h=16, threads_y=4),
    "threads512": dict(threads_y=16, min_blocks=2),
    "nostage": dict(knockout="nostage"),
    "nogather": dict(knockout="nogather"),
}
# The knockouts: a statement of csrc/advect.cu and what replaces it.
KNOCKOUTS = {
    "nostage": ("        for (int k0 = 0; k0 < texels; k0 +=",
                "        for (int k0 = 0; k0 < 0 * texels; k0 +="),
    "nogather": ("            if (i >= H || j >= W) continue;\n            const int xc",
                 "            if (i >= 0) continue;\n            const int xc"),
}


def _sub(text: str, pattern: str, repl: str) -> str:
    out, n = re.subn(pattern, repl, text)
    if n != 1:
        raise SystemExit(f"dye_variants: {pattern!r} matched {n} times in csrc/advect.cu")
    return out


def make(name: str, v: dict) -> Path:
    """The variant's copy of tpufluid_torch, its constants replaced."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(ROOT / "tpufluid_torch", d / "tpufluid_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = d / "tpufluid_torch" / "csrc" / "advect.cu"
    s = cu.read_text()
    for const, key in (("kDyeTileW", "tile_w"), ("kDyeTileH", "tile_h"),
                       ("kDyeThreadsY", "threads_y"), ("kDyeStage", "stage")):
        s = _sub(s, rf"constexpr int {const} = \d+;", f"constexpr int {const} = {v[key]};")
    s = _sub(s, r"constexpr int kDyeSmem = \d+ \* 1024;",
             f"constexpr int kDyeSmem = {v['smem_kb']} * 1024;")
    s = _sub(s, r"__launch_bounds__\(kDyeThreads, \d+\)",
             f"__launch_bounds__(kDyeThreads, {v['min_blocks']})")
    if v["knockout"]:
        old, new = KNOCKOUTS[v["knockout"]]
        if s.count(old) != 1:
            raise SystemExit(f"dye_variants: knockout {v['knockout']} does not apply")
        s = s.replace(old, new)
    cu.write_text(s)
    py = d / "tpufluid_torch" / "ops" / "cuda" / "advect.py"
    s = py.read_text()
    s = _sub(s, r"DYE_TILE = \(\d+, \d+\)", f"DYE_TILE = ({v['tile_h']}, {v['tile_w']})")
    s = _sub(s, r"DYE_SMEM = \d+ \* 1024", f"DYE_SMEM = {v['smem_kb']} * 1024")
    py.write_text(s)
    return d


CELLS = {
    "demo": dict(SIM_RESOLUTION=128, DYE_RESOLUTION=1024, CANVAS_WIDTH=1280, CANVAS_HEIGHT=720,
                 DTYPE="float32"),
    "1024": dict(SIM_RESOLUTION=1024, DYE_RESOLUTION=1024, CANVAS_WIDTH=1024,
                 CANVAS_HEIGHT=1024, DTYPE="bfloat16"),
    "b64": dict(SIM_RESOLUTION=288, DYE_RESOLUTION=288, CANVAS_WIDTH=288, CANVAS_HEIGHT=288,
                DTYPE="bfloat16"),
}
B64 = 64


def flows(path: Path) -> None:
    """The flow states of CELLS, through the checkout's kernels."""
    import torch

    import tpufluid_torch as T

    out = {}
    for name, kw in CELLS.items():
        cfg = T.FluidConfig(MAX_SPLATS=8, **kw).validate()
        if name == "b64":
            seq = torch.as_tensor(np.stack([T.swirl_trace(cfg, 100, seed=42 + i).batches
                                            for i in range(B64)], axis=1), device="cuda")
            state = T.make_batched_multi_step(cfg)(T.init_batch(cfg, B64), 1.0 / 60.0, seq)
            out[name] = (state, seq[-1])
        else:
            trace = T.swirl_trace(cfg, 100, seed=42)
            state = T.make_multi_step(cfg)(T.init_state(cfg), trace.dts, trace.batches)
            out[name] = (state, torch.as_tensor(trace.batches[-1]))
    torch.save(out, path)


def time_variant(tag: str, path: Path) -> None:
    """The DV lines of the tpufluid_torch on PYTHONPATH."""
    import torch

    import tpufluid_torch as T
    from tpufluid_torch.ops.cuda import advect, check
    from tpufluid_torch.ops.cuda.floors import queued_ms, spin_rate

    rate = spin_rate()
    states = torch.load(path, weights_only=False)
    th, tw = advect.DYE_TILE
    for name, kw in CELLS.items():
        cfg = T.FluidConfig(MAX_SPLATS=8, **kw).validate()
        rand = (check.random_batch(cfg, B64, 7, "cuda") if name == "b64"
                else check.random_state(cfg, 7, "cuda"))
        for form, (state, splats) in (("random", rand), ("flow", states[name])):
            case = next(c for c in check.step_cases(state, splats, cfg)
                        if c.label == "advect:dye")
            got, want = case.run(), case.run(plain=True)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            ms = sorted(queued_ms(case.run, 20, rate) for _ in range(3))[1]
            plan = advect.dye_window_plan(*case.args)
            box = plan["box"].reshape(-1, 4).double()
            texels = (box[:, 1] - box[:, 0] + 1) * (box[:, 3] - box[:, 2] + 1)
            print(f"DV {tag} {name} {form} ms {ms:.5f} err {err} fit {plan['share']:.4f} "
                  f"box/tile {float(texels.mean()) / (th * tw):.3f}", flush=True)


def main(argv) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--time", nargs=2, metavar=("TAG", "STATES"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.time:
        time_variant(*args.time)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("dye_variants measures a CUDA GPU and none is available")
    names = args.variants.split(",")
    dirs = {n: make(n, {**BASE, **VARIANTS[n]}) for n in names}
    env = dict(os.environ)
    builds = {n: subprocess.Popen(
        [sys.executable, "-c", "from tpufluid_torch.ops.cuda import build; build.build(['advect'])"],
        cwd=d, env={**env, "PYTHONPATH": str(d)}) for n, d in dirs.items()}
    states = OUT / "flow_states.pt"
    flows(states)
    for n, p in builds.items():
        if p.wait() != 0:
            raise SystemExit(f"dye_variants: variant {n} did not build")
    for n, d in dirs.items():
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--time", n, str(states)],
                       cwd=d, env={**env, "PYTHONPATH": str(d)}, check=True)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"dye variants on {gpu}")


if __name__ == "__main__":
    main(sys.argv[1:])
