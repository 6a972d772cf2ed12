"""Checkpoint / resume, counterpart of ``tpufluid.checkpoint``.

``save_state`` writes the fields, the config, the step cursor and, when a
``tracer`` is passed, the whole input-side session state
(``PointerTracer.state_dict``) to an .npz; ``load_state`` reads one back.
The layout and format version are tpufluid's, so a checkpoint written by
either package loads in the other, bit for bit: float32 and float16 fields
as themselves, bfloat16 (which numpy lacks) as its uint16 bit pattern, the
dtype restored from the config.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np
import torch

from tpufluid_torch.config import FluidConfig
from tpufluid_torch.interop import config_from_dict
from tpufluid_torch.state import FluidState, resolve_device

_FORMAT_VERSION = 1


def _to_npz(t: torch.Tensor) -> np.ndarray:
    """A field as numpy on the host: bfloat16 as its uint16 bit view."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_npz(a: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The inverse of _to_npz for a config of ``dtype``: a uint16 array is
    the bit pattern of a 16-bit float."""
    if a.dtype == np.uint16 and dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16)).view(dtype)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype != dtype:
        raise ValueError(f"checkpoint field of {a.dtype} for a {dtype} config")
    return t.to(device)


def save_state(path, state: FluidState, config: FluidConfig, step: int = 0,
               extra: Optional[dict] = None, tracer=None, compress: bool = True) -> None:
    """Write ``state`` to ``path`` (a path or a binary file object).
    compress=False skips DEFLATE: a latency-sensitive caller (the server's
    /checkpoint.npz) pays seconds of single-core zlib on turbulent 16-bit
    fields for little size; np.load reads both."""
    extra = dict(extra or {})
    if tracer is not None:
        extra["tracer"] = tracer.state_dict()
    meta = {"version": _FORMAT_VERSION, "step": int(step),
            "config": dataclasses.asdict(config), "extra": extra}
    savez = np.savez_compressed if compress else np.savez
    savez(path, velocity=_to_npz(state.velocity), dye=_to_npz(state.dye),
          pressure=_to_npz(state.pressure), meta=json.dumps(meta))


def load_state(path, device="cuda") -> Tuple[FluidState, FluidConfig, int, dict]:
    """(state on ``device``, config, step, extra) of a checkpoint written by
    either package. ``device`` defaults to the GPU and raises without one."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["meta"]))
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(f"unknown checkpoint version {meta['version']}")
        config = config_from_dict(meta["config"])
        state = FluidState(*(_from_npz(data[k], config.dtype, device)
                             for k in ("velocity", "dye", "pressure")))
    return state, config, int(meta["step"]), meta["extra"]
