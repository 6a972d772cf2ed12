"""The port's spans in a benchmark cell: each pass's host time, launches,
device time and idle, on the card.

  python3 -m tpufluid_torch.tools.span_window --workload <cell> --seeds 11,12 \\
      [--seconds 20] [--out out/span_window.jsonl]
  python -m tpufluid_torch.tools.span_window --workload <cell> --cpu     (a rehearsal)

For each seed, one run of the cell (fluidbench's set-up and measured window,
the recorder off), then its traced window with the port's recorder on, then
a span window: turns of as many calls with the recorder on and off, and no
profiler (fluidbench/programspans.py). Prints one JSON line a run: the
cell's own per-layer metrics and the span metrics of
fluidbench/spans_per_layer.json; whether the attribution closes (launches,
device time and idle by span against the trace's, and the port's launches
the timeline places in each span against build.Kernel's count there); the
alignment error in µs; the span window's host ms a unit beside its turns
with the recorder off and the measured window's; every span's numbers; and
the breakdown with the idle gaps named by span. ``--cpu`` runs the cell at
fluidbench.rehearse's size on the CPU: plumbing only, no device number.

A cell on more than one card (the sharded step over its ``chips`` cards)
is read otherwise, since fluidbench's span window aligns one card's
trace: after set-up, ``trace_calls`` calls with the recorder on give each
span's count, host ms, the port's launches and the bytes its halo
exchanges sent between cards a step (the recorder's host summary), and the
column pads a shard a step written in place and concatenated anew
(``halo.PADS``); as many
again with the recorder's profiler ranges on, under torch.profiler with the
host's operators, give each span's device ms, kernels and copies a step,
over every card, each kernel and copy put down to the innermost span whose
range issued it. With ``--cpu`` the mesh's shards are all on the CPU and
only the host summary is read.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
CAPACITY = 1 << 18


LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")


def by_span(events, names) -> Dict[str, Dict[str, float]]:
    """Device µs, kernels and copies between cards of a profile's device
    events, each put down to the innermost span range (one of ``names``,
    the recorder's profiler ranges) open when the runtime call that
    launched it ran (matched by the profiler's correlation id; an event
    with no such call counts as ``outside``). The profiler's own device
    rows of the ranges are left out."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from fluidbench import devtrace, programspans

    ranges, calls, device = [], {}, []
    for e in events:
        start, dur = float(e.time_range.start), float(e.time_range.elapsed_us())
        if e.device_type == DeviceType.CUDA:
            if e.name not in names:
                device.append((e, start, dur))
        elif e.name in names:
            ranges.append(SimpleNamespace(name=e.name, start=start, end=start + dur))
        elif e.name.startswith(LAUNCH_CALLS):
            calls.setdefault(e.id, start + 0.5 * dur)
    line = programspans.Timeline(ranges)
    out: Dict[str, Dict[str, float]] = {}
    for e, start, dur in device:
        at = calls.get(e.id)
        r = out.setdefault(line.at(at) if at is not None else programspans.OUTSIDE_SPAN,
                           {"device_us": 0.0, "kernels": 0, "copies": 0, "copy_us": 0.0})
        r["device_us"] += dur
        kind = devtrace.kind(e.name)
        if kind == "kernel":
            r["kernels"] += 1
        elif kind == "copy_ptop":
            r["copies"] += 1
            r["copy_us"] += dur
    return out


def cards_window(cell, seed: int, devices, spans, trace: bool) -> Dict:
    """A multi-card cell's spans (see the module's doc): one JSON-able dict."""
    from fluidbench import harness, program
    from fluidbench.traffic.generator import generate
    from tpufluid_torch.parallel import halo

    traffic = generate(cell.mix, cell.cfg, seed)
    prog = program.Program(cell.cfg, cell.mix, traffic, devices)
    stride, length = prog.steps, traffic.splats.shape[0]
    box = [prog.call(prog.init(), 0)[0], stride % length]

    def calls(n):
        for _ in range(n):
            box[0], _ = prog.call(box[0], box[1])
            box[1] = (box[1] + stride) % length
        harness._sync(devices)

    calls(cell.mix["warm_calls"])
    n = cell.mix["trace_calls"]
    steps = n * stride
    spans.enable(CAPACITY)
    sent = halo.SENT.bytes
    pads = halo.PADS.in_place, halo.PADS.fresh
    calls(n)
    got: List = spans.take()
    sent = halo.SENT.bytes - sent
    pads = halo.PADS.in_place - pads[0], halo.PADS.fresh - pads[1]
    spans.disable()
    per: Dict[str, Dict] = {}
    for s in got:
        r = per.setdefault(s.name, {"count": 0, "host_ms": 0.0, "port_launches": 0, "bytes": 0})
        r["count"] += 1
        r["host_ms"] += (s.end_ns - s.start_ns) * 1e-6
        r["port_launches"] += s.launches
        r["bytes"] += s.bytes
    for r in per.values():
        for k in r:
            r[k] /= steps
    out = {"workload": cell.name, "seed": seed, "cards": len(harness.cards(devices)),
           "steps": steps, "halo_sent_bytes": sent / steps,
           "col_pads_in_place": pads[0] / (steps * prog.mesh.size),
           "col_pads_fresh": pads[1] / (steps * prog.mesh.size),
           "span_bytes": sum(s.bytes for s in got) / steps,
           "port_launches": sum(s.launches for s in got) / steps, "per_span": per,
           "summary": spans.summary(got)}
    if trace:
        from torch.profiler import ProfilerActivity, profile

        names = set(per)
        spans.enable(CAPACITY, profiler=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            calls(n)
        spans.disable()
        for name, r in by_span(prof.events(), names).items():
            per.setdefault(name, {}).update({k: v / steps for k, v in r.items()})
        out["device"] = {k: sum(r.get(k, 0.0) for r in per.values())
                         for k in ("device_us", "kernels", "copies", "copy_us")}
        out["gpu"] = program.device_name(devices[0])
    del box, prog
    program.release()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m tpufluid_torch.tools.span_window")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="2147483659")
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--cpu", action="store_true", help="a rehearsal on the CPU at a tiny size")
    p.add_argument("--out", default=None, help="also append each run's line to this file")
    args = p.parse_args(argv)
    cache = ROOT / "tpufluid_torch" / "_build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    import torch

    from fluidbench import harness, program, programspans, rehearse
    from tpufluid_torch import spans

    cell = harness.load_cell(args.workload)
    chips = cell.workload["chips"]
    if chips > 1:
        if args.cpu:
            cell = dataclasses.replace(cell, cfg=rehearse.shrink(cell.cfg),
                                       mix=rehearse.shrink_mix(cell.mix))
            devices = [torch.device("cpu")] * chips
        elif torch.cuda.is_available() and torch.cuda.device_count() >= chips:
            devices = [torch.device("cuda", i) for i in range(chips)]
            program.build(cell.mix)
        else:
            print(f"span_window: {args.workload} needs {chips} CUDA devices", file=sys.stderr)
            return 2
        for seed in (int(s) for s in args.seeds.split(",")):
            emit(json.dumps(cards_window(cell, seed, devices, spans, not args.cpu)), args.out)
        return 0
    if args.cpu:
        cell = dataclasses.replace(cell, cfg=rehearse.shrink(cell.cfg),
                                   mix=rehearse.shrink_mix(cell.mix))
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
        program.build(cell.mix)
    else:
        print("span_window: no CUDA device (--cpu for a rehearsal)", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        emit(json.dumps(programspans.run(cell, seed, args.seconds, device, spans)), args.out)
    return 0


def emit(line: str, out) -> None:
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    sys.exit(main())
