"""Build the CUDA kernels of ``tpufluid_torch/csrc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use, with one ``nvcc`` process per
source, into ``tpufluid_torch/_build/<name>-<hash>.so`` (the hash covers the
source, the shared header and the flags, so an edited kernel rebuilds). The
libraries expose plain C entry points that take device pointers and the
stream as ``void*`` and return the ``cudaError_t`` of their launch.

``Kernel`` is the Python face of one entry point: it loads the library,
launches, raises on a non-zero error code, and counts its launches — the
count is how a run shows that the main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# No --use_fast_math: IEEE division and sqrt are part of parity with the
# plain versions, and -fmad=false keeps a*b+c rounding twice as they do.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas=-v")

SOURCES = ("stencil", "jacobi", "advect", "bloom", "display", "floors")

# Storage type codes of csrc/common.cuh.
STORAGE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or
    /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, all nvcc
    processes at once; raise with the compiler's output if one fails. The
    compiler's report (registers, spills) goes to ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = []
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build([name])[name]))
        return _libs[name]


def stream() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream, as the kernels' launch stream."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


KERNELS: Dict[str, "Kernel"] = {}


class Kernel:
    """One C entry point of a ``csrc`` library, with its launch count. The
    ``__global__`` function it launches is named ``<name>_kernel``: that is
    how a profiler's kernel events map back to it (ops/cuda/floors.py)."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: List,
                 replaces: str):
        self.name = name
        self.source = source            # the library: csrc/<source>.cu
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces        # the TPU kernel, file:line
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"kernel {self.name} failed to launch: "
                               f"cudaError_t {err}")
        self.launches += 1


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def check_storage(*tensors: torch.Tensor) -> int:
    """Storage code of tensors the kernels can take: CUDA, contiguous, one of
    the three storage dtypes, all alike. Raises on anything else."""
    t0 = tensors[0]
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"kernel input on {t.device}, expected a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if t.dtype != t0.dtype or t.device != t0.device:
            raise ValueError(f"mixed kernel inputs: {t0.dtype}@{t0.device} "
                             f"and {t.dtype}@{t.device}")
    if t0.dtype not in STORAGE_CODES:
        raise ValueError(f"no kernel for dtype {t0.dtype}")
    return STORAGE_CODES[t0.dtype]


def check_factors(factors, device, h: int, w: int, channels: int):
    """(gy, gx, amt, S) of optional splat factors for the kernels: float32,
    contiguous, on ``device``, shaped (h, S), (S, w), (S, channels)."""
    if factors is None:
        return None, None, None, 0
    gy, gx, amt = factors
    s = gy.shape[1]
    for t, shape in ((gy, (h, s)), (gx, (s, w)), (amt, (s, channels))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"splat factor {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} float32")
        if t.device != device or not t.is_contiguous():
            raise ValueError("splat factors must be contiguous and on the "
                             "field's device")
    return gy, gx, amt, s
