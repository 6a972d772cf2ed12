"""Per-layer metric readers, one module a quantity: ``metrics/<q>.py``
defines ``read(ctx, args)``, which reads the metric ``<q>[.<args>].<unit>``
from a traced run and returns a number, or None where it finds nothing to
read (the harness then leaves the metric out). ``unit`` is the cell's
unit, "step" or "tick"; a metric whose unit is not the cell's is not read.

``ctx`` holds ``digest`` (devtrace.Digest of the traced window), ``shape``
(work.Shape of one unit), ``peaks`` (peaks.json) and ``spans`` (the
benchmark's own spans of the measured window: "host_s", the host seconds
inside the entry's calls, "units", the units those calls ran, and
"window_s", the window's length).
"""

from __future__ import annotations

import importlib
from typing import Optional


def read(name: str, ctx) -> Optional[float]:
    parts = name.split(".")
    if len(parts) < 2 or parts[-1] != ctx["digest"].unit:
        return None
    return importlib.import_module(f"fluidbench.metrics.{parts[0]}").read(ctx, parts[1:-1])


def unit_s(ctx) -> Optional[float]:
    """The measured window's seconds a unit, which the readers of idle time
    and of the peak's share divide by (None for an empty window)."""
    s = ctx["spans"]
    return s["window_s"] / s["units"] if s["units"] and s["window_s"] > 0 else None
