"""Build the CUDA kernels of ``tpufluid_torch/csrc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use, with one ``nvcc`` process per
source, into ``tpufluid_torch/_build/<name>-<hash>.so`` (the hash covers the
source, the shared header and the flags, so an edited kernel rebuilds). The
libraries expose plain C entry points that take device pointers and the
stream as ``void*`` and return the ``cudaError_t`` of their launch.

``Kernel`` is the Python face of one entry point: it loads the library,
launches, raises on a non-zero error code, and counts its launches — the
count is how a run shows that the main path went through the kernel.

A launch goes to the card that holds its tensors: ``stream(t)`` is the
current stream of ``t``'s device, and ``Kernel`` makes that device the CUDA
runtime's current one for the call where it is not already (the entry
points set no device, and the runtime launches on, and grants shared
memory for, its current one). On one card that costs no switch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# No --use_fast_math: IEEE division and sqrt are part of parity with the
# plain versions, and -fmad=false keeps a*b+c rounding twice as they do.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas=-v")

SOURCES = ("stencil", "jacobi", "advect", "bloom", "display", "floors", "sunrays")

# Storage type codes of csrc/common.cuh.
STORAGE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# Field layouts of csrc/common.cuh FieldLayout: B sims as (B, C, H, W), or
# side by side along the rows as (C, H, B*W) (the lane-packed fleet).
BATCHED, PACKED = 0, 1
MAX_BATCH = 65535   # csrc/common.cuh kMaxBatch: the grid's z axis

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


_PTXAS_FN = re.compile(r"Function properties for (\S+)")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")


def ptxas_report(log: str) -> List[dict]:
    """Per compiled function of an ``nvcc -Xptxas=-v`` log: its (mangled)
    name, registers, static shared memory bytes, stack frame bytes and
    spill store / load bytes."""
    out: List[dict] = []
    for line in log.splitlines():
        m = _PTXAS_FN.search(line)
        if m:
            out.append({"function": m.group(1)})
            continue
        if not out:
            continue
        m = _PTXAS_FRAME.search(line)
        if m:
            out[-1].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = _PTXAS_REGS.search(line)
        if m and "registers" not in out[-1]:
            out[-1]["registers"] = int(m.group(1))
            m = _PTXAS_SMEM.search(line)
            out[-1]["smem"] = int(m.group(1)) if m else 0
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build([name])[name]))
        return _libs[name]


class Stream(ctypes.c_void_p):
    """A launch stream. ``device`` is the index of its CUDA device where that
    is not the current device, else None."""

    device: Optional[int] = None


def stream(on: Optional[torch.Tensor] = None) -> Stream:
    """PyTorch's current CUDA stream on the device of the tensor ``on``
    (None: the current device), as the launch stream of a kernel on that
    device's memory."""
    current = torch.cuda.current_device()
    index = current if on is None else on.get_device()
    s = Stream(torch._C._cuda_getCurrentRawStream(index))
    if index != current:
        s.device = index
    return s


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the CUDA device (132 on the H100 SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def smem_optin(device: torch.device) -> int:
    """Shared memory a block of the CUDA device may opt into, in bytes
    (cudaDevAttrMaxSharedMemoryPerBlockOptin: 232,448 on the H100), static
    and dynamic together."""
    return int(torch.cuda.get_device_properties(device).shared_memory_per_block_optin)


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


KERNELS: Dict[str, "Kernel"] = {}


class Kernel:
    """One C entry point of a ``csrc`` library, with its launch count. The
    ``__global__`` function it launches is named ``<name>_kernel``: that is
    how a profiler's kernel events map back to it (ops/cuda/floors.py).
    Its last argument is the launch's ``stream(...)``, whose device is made
    the runtime's current one for the call where it is not already."""

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
        on = args[-1].device if args and isinstance(args[-1], Stream) else None
        if on is None:
            err = self._fn(*args)
        else:
            with torch.cuda.device(on):
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


def as_batch(field: torch.Tensor, sim_ndim: int):
    """(batch, single): ``field`` with a leading batch axis, and whether it
    was one sim of ``sim_ndim`` dimensions (then a view with B = 1). Every
    wrapper takes one sim or a batch of B sims in one launch (a launch
    refuses B outside 1 to 65535, the grid's z axis)."""
    if field.ndim == sim_ndim:
        return field[None], True
    if field.ndim != sim_ndim + 1:
        raise ValueError(f"expected a field of {sim_ndim} dimensions or a batch of them, "
                         f"got {tuple(field.shape)}")
    return field, False


def pack_fleet(x: torch.Tensor) -> torch.Tensor:
    """(B, ..., H, W) -> (..., H, B*W), contiguous: packed column b*W + j
    holds sim b's column j (tpufluid/batch_packed.py:51)."""
    b, h, w = x.shape[0], x.shape[-2], x.shape[-1]
    return torch.movedim(x, 0, -2).reshape(*x.shape[1:-2], h, b * w).contiguous()


def unpack_fleet(x: torch.Tensor, batch: int) -> torch.Tensor:
    """(..., H, B*W) -> (B, ..., H, W), contiguous: the inverse of
    pack_fleet."""
    h, wp = x.shape[-2], x.shape[-1]
    if batch < 1 or wp % batch:
        raise ValueError(f"a packed width of {wp} holds no whole {batch} sims")
    return torch.movedim(x.reshape(*x.shape[:-2], h, batch, wp // batch), -2, 0).contiguous()


def packed_batch(field: torch.Tensor, sim_ndim: int, sim_w: int) -> int:
    """B of a packed field, (..., H, B*sim_w) with ``sim_ndim`` dimensions
    (those of one sim). Raises unless its width is whole sims; a launch
    refuses B outside 1 to 65535."""
    if field.ndim != sim_ndim:
        raise ValueError(f"a packed field has {sim_ndim} dimensions, (..., H, B*W), got "
                         f"{tuple(field.shape)}")
    w = field.shape[-1]
    if sim_w < 1 or w < sim_w or w % sim_w:
        raise ValueError(f"a packed width of {w} is not a whole number of sims {sim_w} wide")
    return w // sim_w


def batch_factors(factors, single: bool):
    """Splat factors of one sim, (h, S), (S, w), (S, C), as a batch of one;
    a batch's (B, h, S), (B, S, w), (B, S, C) as they are."""
    if factors is None or not single:
        return factors
    return tuple(t[None] for t in factors)


def check_factors(factors, device, batch: int, h: int, w: int, channels: int):
    """(gy, gx, amt, S) of optional splat factors of a batch for the
    kernels: float32, contiguous, on ``device``, shaped (batch, h, S),
    (batch, S, w), (batch, S, channels)."""
    if factors is None:
        return None, None, None, 0
    gy, gx, amt = factors
    s = gy.shape[-1]
    for t, shape in ((gy, (batch, h, s)), (gx, (batch, s, w)), (amt, (batch, s, channels))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"splat factor {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} float32")
        if t.device != device or not t.is_contiguous():
            raise ValueError("splat factors must be contiguous and on the "
                             "field's device")
    return gy, gx, amt, s


def check_dt(dt, batch: int, device) -> Tuple[float, ctypes.c_void_p]:
    """(scalar dt, table pointer) of a batched launch's dt, in one of two
    forms: a number, every sim's clamped dt (lock-step: what a single-sim
    step passes; the pointer is null), or a (batch, 2) float32 table of
    (clamped dt, decay) a sim, contiguous on ``device``, that step.dt_table
    computed on the host and copied once (the scalar is then unused).
    Raises on any other tensor: the kernel never reads one."""
    if not isinstance(dt, torch.Tensor):
        return float(dt), ptr(None)
    if dt.dtype != torch.float32 or tuple(dt.shape) != (batch, 2):
        raise ValueError(f"dt table {tuple(dt.shape)} {dt.dtype}, expected "
                         f"({batch}, 2) float32")
    if dt.device != device or not dt.is_contiguous():
        raise ValueError(f"dt table must be contiguous and on {device}, got "
                         f"{dt.device}")
    return 0.0, ptr(dt)


def per_sim(plain, batched: bool, args, fields=(0,), dt_at=None, factors_at=None):
    """A plain version over a batch: ``plain(*args)`` sim by sim, with sim
    b's slice of each field (args[i] for i in ``fields``, where not None),
    of its splat factors (args[factors_at]) and its dt (args[dt_at], a
    number or a (B, 2) table), the results stacked. One sim (``batched``
    false) is one call as it is."""
    if not batched:
        return plain(*args)
    outs = []
    for b in range(args[fields[0]].shape[0]):
        a = list(args)
        for i in fields:
            if args[i] is not None:
                a[i] = args[i][b]
        if dt_at is not None and isinstance(args[dt_at], torch.Tensor):
            a[dt_at] = float(args[dt_at][b, 0])     # the table's clamped dt
        if factors_at is not None and args[factors_at] is not None:
            a[factors_at] = tuple(t[b] for t in args[factors_at])
        outs.append(plain(*a))
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)
