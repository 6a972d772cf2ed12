"""fluidbench: the benchmark of the PyTorch and CUDA port
(``tpufluid_torch``) on an NVIDIA H100.

  python3 -m fluidbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>
  python3 -m fluidbench.control --workload <cell> --seeds a,b,c
  python -m fluidbench.rehearse --workload <cell>          (on the CPU)
  python -m pytest fluidbench/tests                         (on the CPU)

BENCHMARK.json names the cells; each cell's configuration, traffic mix,
comparison limits, per-layer readers and work models are files of their
own here, found by name (harness.py). Only program.py imports the program;
the reference (reference/) imports nothing of it, and nothing here imports
JAX or the JAX package.
"""
