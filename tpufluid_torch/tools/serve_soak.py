#!/usr/bin/env python3
"""Multi-tenant serving soak with a HARD latency bar, the counterpart of
tools/serve_soak.py: drive a live BatchFluidServer with concurrent random
event streams, frame polls, fleet resizes and checkpoints for a fixed wall
time, write a machine-readable summary (--out) and FAIL (exit 1) unless
every bar below holds.

What it certifies:
- the sim loop survives the whole soak (server.error stays None);
- steps keep advancing (no deadlock between the event, resize and
  checkpoint locks and the loop);
- every call completes;
- the final fleet state is finite and consistent (sessions == len(speeds));
- HARD bars on in-process calls (so the numbers measure lock waits and
  serving-path work, not the HTTP stack):
    events     p99 <= 250 ms  (every input lands within one 16.7 ms frame
                               of the reference, script.js:1185)
    resize     p99 <= 5 s     (two-phase: bookkeeping only; the reconciler
                               swaps off the request path)
    checkpoint p99 <= 1 s     (a host copy under the locks, or the rolling
                               snapshot while a tick is on the device)
    frame      p99 <= 250 ms  (lazy JPEG encode + lock reads)
  and at least 10 resizes executed during the soak.

``soak`` runs the workers and returns the summary; ``verdict`` applies the
bars; ``main`` does both, at tools/serve_soak.py's geometry (sim 32, dye
64, 96x64, MAX_SPLATS 4), and writes the summary. The soak runs on the GPU
unless TPUFLUID_DEVICE=cpu is set.

  python -m tpufluid_torch.tools.serve_soak --seconds 600 \\
      --out out/serve_soak_torch/summary.json
  TPUFLUID_DEVICE=cpu python -m tpufluid_torch.tools.serve_soak --seconds 60
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import threading
import time

import torch

from tpufluid_torch.config import FluidConfig
from tpufluid_torch.serve_batch import BatchFluidServer
from tpufluid_torch.state import device_from_env

SLO_MS = {"events": 250.0, "resize": 5000.0, "checkpoint": 1000.0, "frame": 250.0}
MIN_RESIZES = 10
START_TIMEOUT_S = 600.0   # the first frame, kernel build excluded (the constructor's)


def soak(config: FluidConfig, seconds: float, sessions: int = 3, max_resize: int = 5,
         seed: int = 0, device="cuda") -> dict:
    """Run the soak's workers against a fresh BatchFluidServer (prewarm
    'all') for ``seconds`` and return the summary: the loop's error, steps
    during the soak, call failures, the final fleet's consistency and
    finiteness, the program errors and each call kind's latency (n, p50,
    p99, max ms beside its bar). The bars are not applied here."""
    srv = BatchFluidServer(config, sessions=sessions, seed=seed, prewarm="all", device=device)
    loop = threading.Thread(target=srv.run, daemon=True)
    loop.start()
    t_end = time.time() + START_TIMEOUT_S
    while srv.frames is None and srv.error is None:
        if time.time() > t_end:
            srv.stop()
            raise RuntimeError(f"no frame within {START_TIMEOUT_S} s")
        time.sleep(0.1)
    if srv.error is not None:
        srv.stop()
        raise RuntimeError(srv.error)

    stop_at = time.time() + seconds
    lat = {"events": [], "resize": [], "checkpoint": [], "frame": []}
    failures = []

    def timed(kind, fn, sid_call=False):
        t0 = time.time()
        try:
            fn()
        except ValueError:
            # An out-of-range sid after a concurrent shrink is DEFINED
            # behavior for sid-taking calls only; a ValueError from resize
            # or checkpoint on valid input is a real failure.
            if not sid_call:
                failures.append((kind, "unexpected ValueError"))
        except Exception as e:  # noqa: BLE001
            failures.append((kind, repr(e)))
        lat[kind].append(time.time() - t0)

    def worker(kind, wseed):
        rng = random.Random(wseed)
        while time.time() < stop_at:
            if kind == "events":
                # Valid sids only (the fleet never exceeds max_resize);
                # concurrent shrinks still make some racily out of range.
                sid = rng.randrange(max_resize)
                # speed spans [0, SPEED_MAX + 0.5): slow motion, the 1x
                # lock-step path, fast-forward (K-substep programs racing
                # the resizes) and values past the cap.
                evs = [{"k": "down", "x": rng.random(), "y": rng.random()},
                       {"k": "move", "x": rng.random(), "y": rng.random()},
                       {"k": "up"}, {"k": "speed", "v": rng.random() * 4.5}]
                timed(kind, lambda: srv.handle_events(evs, sid), sid_call=True)
            elif kind == "resize":
                # Adversarial cadence: 1..max_resize spans padded sizes 1, 2,
                # 4 and 8, so swaps race the ticks.
                n = rng.randrange(1, max_resize + 1)
                timed(kind, lambda: srv.resize_fleet(n))
                time.sleep(max(2.0, seconds / 60.0))
            elif kind == "checkpoint":
                timed(kind, srv.checkpoint_bytes)
                time.sleep(2.0)
            else:
                sid = rng.randrange(max_resize)
                timed(kind, lambda: srv.frame_jpeg(sid), sid_call=True)
            time.sleep(0.02)

    kinds = ["events", "events", "resize", "checkpoint", "frame", "frame"]
    threads = [threading.Thread(target=worker, args=(k, 100 + i)) for i, k in enumerate(kinds)]
    t0_steps = srv.steps_done
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    steps = srv.steps_done - t0_steps
    srv.stop()
    loop.join(timeout=30)
    loop_exited = not loop.is_alive()

    def pct(xs, q):
        if not xs:
            return None
        xs = sorted(xs)
        return round(xs[min(len(xs) - 1, int(len(xs) * q))] * 1e3, 2)

    # Bounded acquire: if the loop hangs HOLDING the lock (the deadlock
    # class the soak exists to catch), report it instead of hanging too.
    locked = srv.lock.acquire(timeout=30)
    try:
        consistent = srv.sessions == len(srv.speeds) == len(srv.tracers)
        finite = locked and all(bool(torch.isfinite(getattr(srv.state, f).float()).all())
                                for f in ("velocity", "dye", "pressure"))
        prog_errors = dict(srv._prog_errors) if locked else {}
    finally:
        if locked:
            srv.lock.release()
    return {
        "seconds": seconds,
        "device": str(srv.device),
        "steps_during_soak": steps,
        "loop_error": srv.error,
        "loop_exited_cleanly": loop_exited,
        "lock_acquirable_after_soak": locked,
        "call_failures": failures[:20],
        "n_failures": len(failures),
        "final_sessions": srv.sessions,
        "fleet_consistent": consistent,
        "state_finite": finite,
        "program_compile_errors": {str(k): v[-400:] for k, v in prog_errors.items()},
        "latency_ms": {k: {"n": len(v), "p50": pct(v, 0.50), "p99": pct(v, 0.99),
                           "max": pct(v, 1.0), "slo_p99_ms": SLO_MS[k]}
                       for k, v in lat.items()},
    }


def verdict(summary: dict):
    """(bar violations, ok) of a soak summary: ok needs no loop error, no
    failed call, steps advancing, a consistent and finite fleet, a loop that
    exited and a lock that could be taken, no program error and no
    violated bar."""
    latency = summary["latency_ms"]
    violations = [f"{k} p99 {latency[k]['p99']} ms > SLO {SLO_MS[k]} ms" for k in SLO_MS
                  if latency[k]["p99"] is not None and latency[k]["p99"] > SLO_MS[k]]
    if latency["resize"]["n"] < MIN_RESIZES:
        violations.append(f"only {latency['resize']['n']} resizes executed (< {MIN_RESIZES})")
    ok = (summary["loop_error"] is None and summary["n_failures"] == 0
          and summary["steps_during_soak"] > 0 and summary["fleet_consistent"]
          and summary["state_finite"] and summary["loop_exited_cleanly"]
          and summary["lock_acquirable_after_soak"]
          and not summary["program_compile_errors"] and not violations)
    return violations, ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seconds", type=float, default=600.0)
    p.add_argument("--sessions", type=int, default=3)
    p.add_argument("--max-resize", type=int, default=5)
    p.add_argument("--out", default="out/serve_soak_torch/summary.json")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    cfg = FluidConfig(SIM_RESOLUTION=32, DYE_RESOLUTION=64, CANVAS_WIDTH=96, CANVAS_HEIGHT=64,
                      MAX_SPLATS=4).validate()
    summary = soak(cfg, args.seconds, args.sessions, args.max_resize, args.seed,
                   device=device_from_env())
    summary["slo_violations"], summary["ok"] = verdict(summary)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
