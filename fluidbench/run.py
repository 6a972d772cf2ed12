"""The benchmark of the PyTorch and CUDA port on the card.

  python3 -m fluidbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs the cell on its ``chips`` cards, cuda:0 .. chips - 1. Builds the
kernel libraries the cell launches (into the package's build directory
inside the checkout; later runs load them), makes the cell's state
and traffic from the seed, warms up, measures for ``--seconds``, compares
the kept calls with the reference, and prints one JSON line. ``--trace 1``
adds a traced window after the measured one and reports the per-layer
metrics in place of the end-to-end ones. Exits non-zero, printing no
result, without enough CUDA devices, or where JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m fluidbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def caches() -> None:
    """Kernel caches at fixed paths inside the checkout (the build directory
    the program's own build uses is there too)."""
    cache = ROOT / "tpufluid_torch" / "_build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def execute(cell, seed: int, seconds: float, trace: bool, devices) -> int:
    """Build the cell's libraries, run it on ``devices`` and print its
    result, unless JAX or the JAX package was loaded."""
    from fluidbench import harness, program

    program.build(cell.mix)
    result = harness.run(cell, seed, seconds, trace, devices, T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"fluidbench: loaded {', '.join(bad)}: the benchmark must not load JAX or the "
              f"JAX package", file=sys.stderr)
        return 3
    harness.report(result)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    caches()
    import torch

    from fluidbench import harness

    cell = harness.load_cell(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"fluidbench: {args.workload} needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    # The cell's cards, cuda:0 .. chips - 1: never fewer, never the CPU.
    return execute(cell, args.seed, args.seconds, bool(args.trace),
                   [torch.device("cuda", i) for i in range(chips)])


if __name__ == "__main__":
    sys.exit(main())
