"""Time the candidate designs of the redesigned kernels on the card.

    python -m tpufluid_torch.tools.kernel_candidates [--iters 20] [--json PATH]

Pre-pressure: on the demo's 128x228 float32, 1024x1024 bfloat16 and
4096x4096 bfloat16 (velocity and 8 splat rows, 7 of them active, from
numpy, seed 0), one launch on each tile of ops/cuda/stencil.py TILES, with
the splat factors and without them.

Jacobi: on 1024x1024 bfloat16 and the demo's 128x228 float32 (pressure,
divergence and velocity from numpy, seed 0), a solve of ``--iters`` sweeps
cut into launches of K = 1, 4, 5, 8, 10 and 20 sweeps (where the grid's
tiles, ops/cuda/jacobi.py tiles_for, leave room for a K-deep halo), and the
step's form of it, the last launch jacobi_project with the gradient
subtract fused in (where they leave room for a K + 1-deep halo).

Bloom: the pyramid at the demo's base (256x455, 7 mips) and 1024x1024's
(256x256, 7 mips), base from numpy (seed 0), in its one cooperative launch
(the designs it beat are gone; their times are in PERF.md), and batched,
at 1024x1024's base for B = 16, 132, 133 and 264 sims, in its one launch
for every sim (the plans it beat, too, are gone).

Display: at the demo (f32 dye 1024x1820 -> 720x1280) and 1024x1024 (bf16
dye), with bloom, sunrays and dither from numpy (seed 0): the composite
with and without shading, composed and not, in both forms (the staged one,
which the wrapper picks there, and the direct one). Then the direct form
where the staged window does not fit (the first four of
check.DIRECT_GEOMETRIES: the server's CLI dye at 200x112, dye 1024 at
500x281, the app's at 256x256, a 4096 dye at 1280x720), in float32 and
bf16 (RGB9E5), one sim and a batch of DIRECT_BATCH, on check.random_state
(random_batch), each beside its bound, max(bytes / 3.35 TB/s, operations /
67 TFLOP/s), from the render case's bytes and check._display_flops; and
the staged form too where a 16-bit window fits.

Sunrays: the fleet's geometry (16 sims of a 1820x1024 float32 dye, rays
348x196) and one sim at the demo and at 1024x1024, dyes from numpy (seed
0) about the mask's knees: the march and blur launches, and the march
alone beside them (the designs they beat, a march of one thread a texel
and its fusion into the blur, are gone; their times are in PERF.md),
beside the bound (check.render_cases' bytes and operations)
and the plain version's ms (one call queued: its 324 launches would
overfill the device's queue at 20).

Floors (the profiling path's yardsticks, at their defaults): floor_sweep's
16 x 20 sweeps of 256x1024 at K = 1, 2, 4, 5, 10 and 20 sweeps between
grid barriers, each on sweep_plan's geometry for that K;
floor_taa at (2, 8, 32, 8) with each word's (trip, rep) terms cut over 1,
2, 4, 8 and 16 threads (taa_plan; TAA_THREADS a block), each also at twice
the trips; floor_roll at (2, 96, 384) with 256 trips, 4 or 8 rows a thread
and each word's trips over 1, 2, 4, 8 and 16 threads (roll_plan), each
also at twice the trips. Each is held to its plain version on the microbenchmark's
inputs and on check.random_floors_cases before it is timed.

Rates (``--only rates``): the three reference rates' chains, each call's
output the next one's seed, timed two ways, from the host (CUDA events
around 30 calls after 10) and on the device (the same 30 queued behind a
spin kernel, as ops/cuda/floors.py's _event_rate). It calls only
floors.taa / roll / sweep, queued_ms and the plain module's input makers,
so an older checkout of the package can be timed by putting it first on
PYTHONPATH and running this file as a script.

Every candidate must equal its plain version bit for bit. Prints one line
per candidate: its device ms (spin-queued CUDA events, as chip_smoke.py
times), its launches and the card's name and power limit; ``--json``
writes the rows. ``--only`` takes a comma-separated list of sections
(stencil, jacobi, bloom, display, sunrays, floors, rates; all but rates
by default).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from tpufluid_torch import FluidConfig
from tpufluid_torch.ops import floors as plain_floors
from tpufluid_torch.ops.cuda import bloom, check, display, jacobi, stencil, sunrays
from tpufluid_torch.ops.cuda import floors
from tpufluid_torch.ops.cuda.build import sm_count
from tpufluid_torch.ops.cuda.floors import queued_ms, spin_rate
from tpufluid_torch.ops.splat import splat_factors

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
F32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
GRIDS = (("1024_bfloat16", 1024, 1024, torch.bfloat16),
         ("demo_float32", 128, 228, torch.float32))
SWEEPS = (1, 4, 5, 8, 10, 20)


STENCIL_GRIDS = (("demo_float32", 128, 228, torch.float32),
                 ("1024_bfloat16", 1024, 1024, torch.bfloat16),
                 ("4096_bfloat16", 4096, 4096, torch.bfloat16))


def stencil_rows(rate: float, gpu: str) -> list:
    rng = np.random.default_rng(0)
    sms = sm_count(torch.device("cuda"))
    rows = []
    for name, h, w, dtype in STENCIL_GRIDS:
        vel = np.clip(rng.standard_normal((2, h, w), dtype=np.float32) * 400, -1000, 1000)
        vel = torch.from_numpy(vel).cuda().to(dtype)
        s = np.zeros((8, 8), np.float32)
        s[:, 0:4] = rng.random((8, 4)) * np.array([1, 1, 1000, 1000]) - [0, 0, 500, 500]
        s[:-1, 7] = 1.0
        factors = splat_factors(torch.from_numpy(s).cuda(), h, w, 0.0025, w / h, slice(2, 4))
        picked = stencil.plan(h, w, sms)
        for fac in (factors, None):
            want = stencil.pre_pressure_plain(vel, 30.0, 1 / 60, fac)
            for n, t in enumerate(stencil.TILES):
                def run():
                    return stencil.run_tiles(vel, 30.0, 1 / 60, fac, n)

                err = max(float((g.float() - x.float()).abs().max())
                          for g, x in zip(run(), want))
                ms = queued_ms(run, 20, rate)
                rows.append({"kernel": "pre_pressure", "grid": name, "th": t.th, "tw": t.tw,
                             "splats": fac is not None, "blocks": t.blocks(h, w),
                             "overcompute": t.overcompute(), "planned": n == picked,
                             "launches": 1, "ms": ms, "max_abs_err": err})
                print(f"pre_pressure candidate {name:14s} {t.th:2d}x{t.tw:3d} tiles "
                      f"{'7 splats' if fac else 'no splat'}, {t.blocks(h, w):5d} blocks, "
                      f"overcompute {t.overcompute():.3f}{' (plan)' if n == picked else ''}: "
                      f"{ms:.4f} ms, max_abs_err {err:.1e} on {gpu}", flush=True)
    return rows


def jacobi_rows(iters: int, rate: float, gpu: str) -> list:
    rng = np.random.default_rng(0)
    sms = sm_count(torch.device("cuda"))
    rows = []
    for name, h, w, dtype in GRIDS:
        p = torch.from_numpy(rng.standard_normal((h, w), dtype=np.float32)).cuda().to(dtype)
        d = torch.from_numpy(rng.standard_normal((h, w), dtype=np.float32)).cuda().to(dtype)
        vel = np.clip(rng.standard_normal((2, h, w), dtype=np.float32) * 400, -1000, 1000)
        vel = torch.from_numpy(vel).cuda().to(dtype)
        want = jacobi.jacobi_plain(p, d, iters, 0.8).float()
        want_v = jacobi.jacobi_project_plain(p, d, vel, iters, 0.8)[1].float()
        t = jacobi.TILES[jacobi.tiles_for(h, w, sms)]
        for k in SWEEPS:
            cut = jacobi.chunks(iters, k)
            for fused in (False, True):
                if k > min(t.max_sweeps(), iters) or (fused and cut[-1] > t.max_sweeps(True)):
                    continue
                if fused:
                    def run():
                        return jacobi.run_project(p, d, vel, 0.8, cut)

                    err = max(float((g.float() - x).abs().max())
                              for g, x in zip(run(), (want, want_v)))
                else:
                    def run():
                        return jacobi.run_chunks(p, d, 0.8, cut)

                    err = float((run().float() - want).abs().max())
                ms = queued_ms(run, 20, rate)
                design = sum(t.blocks(h, w, kk, fused and n == len(cut) - 1) * t.rh * t.rw * kk
                             for n, kk in enumerate(cut))
                kernel = "jacobi_project" if fused else "jacobi_chunk"
                row = {"kernel": kernel, "grid": name, "rw": t.rw, "rh": t.rh,
                       "threads": t.rw * t.ny, "rows_a_thread": t.r,
                       "min_blocks": t.min_blocks, "sweeps_a_launch": k, "launches": len(cut),
                       "ms": ms, "overcompute": design / (h * w * iters), "max_abs_err": err}
                rows.append(row)
                print(f"jacobi candidate {name:14s} ({t.rh}x{t.rw} region, {t.rw * t.ny} "
                      f"threads, {t.r} rows a thread, {t.min_blocks} a SM) K={k:2d} launches "
                      f"{len(cut):2d}{', the last fused' if fused else ''}: {ms:.4f} ms, "
                      f"overcompute {row['overcompute']:.3f}, max_abs_err {err:.1e} on {gpu}",
                      flush=True)
    return rows


RENDER_CONFIGS = (("demo_float32", dict(CANVAS_WIDTH=1280, CANVAS_HEIGHT=720), torch.float32),
                  ("1024_bfloat16", dict(DYE_RESOLUTION=1024, CANVAS_WIDTH=1024,
                                         CANVAS_HEIGHT=1024), torch.bfloat16))


def bloom_rows(rate: float, gpu: str) -> list:
    rng = np.random.default_rng(0)
    rows = []
    for name, kw, _ in RENDER_CONFIGS:
        cfg = FluidConfig(**kw).validate()
        mips = cfg.bloom_mip_sizes()
        bw, bh = cfg.bloom_size
        base = torch.from_numpy((rng.random((3, bh, bw)) * 2.0).astype(np.float32)).cuda()
        args = (base, mips, cfg.BLOOM_THRESHOLD, cfg.BLOOM_SOFT_KNEE, cfg.BLOOM_INTENSITY)
        want = bloom.bloom_pyramid_plain(*args)
        small = bloom.small_level([(h, w) for w, h in mips])
        barriers = len(bloom.stage_plan(len(mips), small)) - 1

        def run():
            return bloom.bloom_pyramid(*args)

        err = float((run() - want).abs().max())
        ms = queued_ms(run, 20, rate)
        rows.append({"kernel": "bloom_pyramid", "grid": name, "small_level": small,
                     "grid_barriers": barriers, "launches": 1, "ms": ms, "max_abs_err": err})
        print(f"bloom candidate {name:14s} small from m{small}, {barriers} grid barriers: "
              f"{ms:.4f} ms, max_abs_err {err:.1e} on {gpu}", flush=True)
    return rows


BLOOM_BATCHES = (16, 132, 133, 264)


def bloom_batch_rows(rate: float, gpu: str) -> list:
    """The batched pyramid at 1024x1024's base in its one launch for every
    sim (the plans it beat are gone; their times are in PERF.md)."""
    rng = np.random.default_rng(0)
    cfg = FluidConfig(**RENDER_CONFIGS[1][1]).validate()
    rest = (cfg.bloom_mip_sizes(), cfg.BLOOM_THRESHOLD, cfg.BLOOM_SOFT_KNEE,
            cfg.BLOOM_INTENSITY)
    bw, bh = cfg.bloom_size
    rows = []
    for batch in BLOOM_BATCHES:
        base = torch.from_numpy((rng.random((batch, 3, bh, bw)) * 2.0).astype(np.float32)).cuda()
        err = float((bloom.bloom_pyramid(base, *rest)
                     - bloom.bloom_pyramid_plain(base, *rest)).abs().max())
        ms = queued_ms(lambda: bloom.bloom_pyramid(base, *rest), 20, rate)
        rows.append({"kernel": "bloom_pyramid", "grid": f"1024_bfloat16:b{batch}",
                     "launches": 1, "ms": ms, "max_abs_err": err})
        print(f"bloom candidate b{batch:<4d} one launch: {ms:.4f} ms, max_abs_err {err:.1e} "
              f"on {gpu}", flush=True)
    return rows


def display_rows(rate: float, gpu: str) -> list:
    from tpufluid_torch.render import blue_noise

    rng = np.random.default_rng(0)
    rows = []
    for name, kw, dtype in RENDER_CONFIGS:
        cfg = FluidConfig(**kw).validate()
        (dw, dh), (bw, bh), (sw, sh) = cfg.dye_size, cfg.bloom_size, cfg.sunrays_size
        out_hw = (cfg.CANVAS_HEIGHT, cfg.CANVAS_WIDTH)

        def t(*shape):
            return torch.from_numpy((rng.random(shape) * 1.5).astype(np.float32)).cuda()

        dye = t(3, dh, dw).to(dtype)
        extras = (t(3, bh, bw), t(sh, sw), blue_noise(dye.device))
        for shading, compose in ((True, True), (False, True), (True, False), (False, False)):
            want = display.display_plain(dye, out_hw, shading, *extras, compose=compose)
            for form in display.FORMS:
                def run():
                    return display.display(dye, out_hw, shading, *extras, compose=compose,
                                           force=form)

                err = float((run() - want).abs().max())
                ms = queued_ms(run, 20, rate)
                row = {"kernel": "display", "grid": name, "shading": shading,
                       "compose": compose, "form": form, "launches": 1, "ms": ms,
                       "max_abs_err": err}
                rows.append(row)
                print(f"display candidate {name:14s} shading={int(shading)} "
                      f"compose={int(compose)} {form}: {ms:.4f} ms, max_abs_err {err:.1e} "
                      f"on {gpu}", flush=True)
    return rows


# (label, config, sims) of the sunrays' candidates: the fleet first.
SUNRAYS_CELLS = (("fleet16", dict(DYE_RESOLUTION=1024, CANVAS_WIDTH=1280, CANVAS_HEIGHT=720), 16),
                 ("demo", dict(DYE_RESOLUTION=1024, CANVAS_WIDTH=1280, CANVAS_HEIGHT=720), 1),
                 ("1024", dict(DYE_RESOLUTION=1024, CANVAS_WIDTH=1024, CANVAS_HEIGHT=1024), 1))


def sunrays_rows(rate: float, gpu: str) -> list:
    from tpufluid_torch.ops.cuda.build import ptr, stream
    from tpufluid_torch.ops.sunrays import apply_sunrays

    rng = np.random.default_rng(0)
    rows = []
    for name, kw, sims in SUNRAYS_CELLS:
        cfg = FluidConfig(**kw).validate()
        (dw, dh), (sw, sh) = cfg.dye_size, cfg.sunrays_size
        lead = (sims,) if sims > 1 else ()
        dye = torch.from_numpy((rng.random(lead + (3, dh, dw)) * 0.06 - 0.01)
                               .astype(np.float32)).cuda()
        args = (dye, (sh, sw), cfg.SUNRAYS_WEIGHT)
        want = apply_sunrays(*args)
        nbytes = check._bytes(dye, want)
        bound = max(nbytes / HBM_BYTES_PER_S, sims * check._sunrays_flops((sh, sw))
                    / F32_FLOPS_PER_S) * 1e3
        plain_ms = queued_ms(lambda: apply_sunrays(*args), 1, rate)
        tab = sunrays.tables((dh, dw), (sh, sw), dye.device)
        bounds = sunrays.band_bounds((dh, dw), (sh, sw), dye.device)
        taps = torch.empty((sims, sunrays.TAPS, sh, sw), dtype=torch.float32, device=dye.device)

        def march():
            sunrays.SUNRAYS(ptr(dye), ptr(taps), sims, dh, dw, sh, sw, ptr(tab), ptr(bounds),
                            stream(dye))

        def run():
            return sunrays.sunrays(*args)

        err = float((run() - want).abs().max())
        ms, march_ms = queued_ms(run, 20, rate), queued_ms(march, 20, rate)
        rows.append({"kernel": "sunrays", "grid": name, "sims": sims, "launches": 2, "ms": ms,
                     "march_ms": march_ms, "bound_ms": bound, "plain_ms": plain_ms,
                     "bytes": nbytes, "max_abs_err": err})
        print(f"sunrays candidate {name:8s} b{sims:<3d} march + blur: {ms:.4f} ms (march "
              f"{march_ms:.4f}), bound {bound:.4f}, plain {plain_ms:.4f} ms, max_abs_err "
              f"{err:.1e} on {gpu}", flush=True)
    return rows


# The demo's dye shown at smaller 16:9 canvases: the staged form's shared
# memory a block grows as the canvas shrinks, past half an SM's at ~110 KB.
THRESHOLD_HEIGHTS = (720, 600, 540, 480, 432, 400, 360, 320)


def threshold_rows(rate: float, gpu: str) -> list:
    from tpufluid_torch.ops.cuda.build import smem_optin
    from tpufluid_torch.render import blue_noise

    limit = smem_optin(torch.device("cuda"))
    rng = np.random.default_rng(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for ch in THRESHOLD_HEIGHTS:
            cw = round(ch * 16 / 9)
            cfg = FluidConfig(CANVAS_WIDTH=cw, CANVAS_HEIGHT=ch).validate()
            (dw, dh), (bw, bh), (sw, sh) = cfg.dye_size, cfg.bloom_size, cfg.sunrays_size

            def t(*shape):
                return torch.from_numpy((rng.random(shape) * 1.5).astype(np.float32)).cuda()

            dye = t(3, dh, dw).to(dtype)
            extras = (t(3, bh, bw), t(sh, sw), blue_noise(dye.device))
            smem = display.smem_bytes(3, *display.window(dh, dw, ch, cw, True), True,
                                      dye.element_size())
            want = display.display_plain(dye, (ch, cw), True, *extras)
            for form in display.FORMS:
                if form == "staged" and smem > limit:
                    continue

                def run():
                    return display.display(dye, (ch, cw), True, *extras, force=form)

                err = float((run() - want).abs().max())
                ms = queued_ms(run, 20, rate)
                rows.append({"kernel": "display", "grid": f"{dh}x{dw}->{ch}x{cw}",
                             "dtype": str(dtype)[6:], "form": form, "staged_smem": smem,
                             "launches": 1, "ms": ms, "max_abs_err": err})
                print(f"display threshold {str(dtype)[6:]:8s} {dh}x{dw} -> {ch}x{cw} staged "
                      f"{smem} B a block: {form} {ms:.4f} ms, max_abs_err {err:.1e} on {gpu}",
                      flush=True)
    return rows


DIRECT_TIMED = ("server_cli_200x112", "server_high_500x281", "app_canvas_256x256",
                "dye4096_1280x720")
DIRECT_BATCH = 4


def direct_rows(rate: float, gpu: str) -> list:
    rows = []
    for label in DIRECT_TIMED:
        res, cw, ch, _ = check.DIRECT_GEOMETRIES[label]
        for dtype, rgb9e5 in (("float32", False), ("bfloat16", True)):
            cfg = FluidConfig(DYE_RESOLUTION=res, CANVAS_WIDTH=cw, CANVAS_HEIGHT=ch,
                              DTYPE=dtype, DYE_RGB9E5=rgb9e5).validate()
            for batch in (1, DIRECT_BATCH):
                if batch == 1:
                    state, _ = check.random_state(cfg, 0, "cuda")
                    case = check.render_cases(state, cfg)[-1]
                else:
                    state, _ = check.random_batch(cfg, batch, 0, "cuda")
                    case = check.batched_render_cases(state, cfg)[-1]
                want = case.run(plain=True)
                bound = 1e3 * max(case.nbytes / HBM_BYTES_PER_S, case.flops / F32_FLOPS_PER_S)
                by = ("bytes" if case.nbytes / HBM_BYTES_PER_S >= case.flops / F32_FLOPS_PER_S
                      else "operations")
                forms = ("direct",) if case.kernel_name == "display_direct" else display.FORMS
                for form in forms:
                    def run():
                        return display.display(*case.args, force=form)

                    err = float((run() - want).abs().max())
                    ms = queued_ms(run, 20, rate)
                    row = {"kernel": "display_direct" if form == "direct" else "display",
                           "grid": label, "dtype": dtype, "batch": batch, "form": form,
                           "picked": case.kernel_name, "launches": 1, "ms": ms,
                           "bound_ms": bound, "bound_by": by, "max_abs_err": err}
                    rows.append(row)
                    print(f"display candidate {label:20s} {dtype:8s} b{batch} {form} (the "
                          f"wrapper picks {case.kernel_name}): {ms:.4f} ms, bound {bound:.4f} "
                          f"ms ({by}), max_abs_err {err:.1e} on {gpu}", flush=True)
                del state, case, want
                torch.cuda.empty_cache()
    return rows


SWEEP_KS = (1, 2, 4, 5, 10, 20)


def _floors_inputs(kernel: str) -> list:
    """The microbenchmark's own inputs and check.random_floors_cases' at
    the default shapes, for ``kernel``."""
    return [c.args for c in check.floors_cases("cuda") + check.random_floors_cases("cuda")
            if c.kernel_name == kernel]


def _candidate(rows: list, row: dict, run, want, rate: float, gpu: str, what: str) -> None:
    """Hold ``run`` to each of ``want`` (one per input set), then time it on
    the first; adds the row."""
    err = 0.0
    for r, w in zip(run, want):
        err = max(err, check.compare(r(), w)[0])
    row.update(ms=queued_ms(run[0], 20, rate), max_abs_err=err)
    rows.append(row)
    print(f"{row['kernel']} candidate {what}: {row['ms']:.4f} ms, max_abs_err {err:.1e} "
          f"on {gpu}", flush=True)


def sweep_rows(rate: float, gpu: str) -> list:
    sms = sm_count(torch.device("cuda"))
    cases = _floors_inputs("floor_sweep")
    want = [plain_floors.sweep_plain(*a) for a in cases]
    chunks, sweeps, h, w = check.SWEEP_DEFAULT
    total = chunks * sweeps
    rows = []
    planned = floors.sweep_plan(h, w, total, sms)
    for k in SWEEP_KS:
        plan = floors.sweep_plan(h, w, total, sms, k)
        over = plan.design_cell_sweeps() / (h * w * total)
        run = [lambda a=a, p=plan: floors.run_sweep(a[0], a[1], p) for a in cases]
        mark = " (plan)" if plan == planned else ""
        _candidate(rows, {"kernel": "floor_sweep", "sweeps_a_phase": k,
                          "rows_a_thread": plan.r, "region": (plan.rh, plan.rw),
                          "tile": plan.tile, "blocks": plan.blocks,
                          "grid_barriers": plan.barriers, "overcompute": over,
                          "planned": plan == planned, "launches": 1}, run, want, rate, gpu,
                   f"K={k:2d} region {plan.rh}x{plan.rw} ({plan.r} rows a thread) tile "
                   f"{plan.tile[0]}x{plan.tile[1]} {plan.blocks} blocks {plan.barriers} grid "
                   f"barriers overcompute {over:.3f}{mark}")
    return rows


def taa_rows(rate: float, gpu: str) -> list:
    sms = sm_count(torch.device("cuda"))
    cases = _floors_inputs("floor_taa")
    want = [plain_floors.taa_plain(*a) for a in cases]
    planes, n_idx, reps, trips = check.TAA_DEFAULT
    tile = (plain_floors.ROWS, plain_floors.LANE)
    planned = floors.taa_plan(planes, n_idx, reps, trips, *tile, sms)
    rows = []
    for splits in floors.TAA_SPLITS:
        plan = floors.taa_plan(planes, n_idx, reps, trips, *tile, sms, splits)
        run = [lambda a=a, p=plan: floors.run_taa(a[0], a[1], a[2], a[3], p) for a in cases]
        mark = " (plan)" if plan == planned else ""
        _candidate(rows, {"kernel": "floor_taa", "splits": splits, "words_a_block": plan.words_b,
                          "blocks": plan.blocks, "threads": plan.threads, "smem": plan.smem,
                          "planned": plan == planned, "launches": 1}, run, want, rate, gpu,
                   f"{splits:2d} threads a word: {plan.blocks} blocks of {plan.threads} threads "
                   f"({plan.words_b} words, {plan.smem} B of shared memory){mark}")
        twice = floors.taa_plan(planes, n_idx, reps, 2 * trips, *tile, sms, splits)
        a = cases[0]
        rows[-1]["twice_trips_ms"] = ms = queued_ms(
            lambda: floors.run_taa(a[0], a[1], a[2], 2 * a[3], twice), 20, rate)
        print(f"floor_taa candidate {splits:2d} threads a word at {2 * trips} trips: "
              f"{ms:.4f} ms on {gpu}", flush=True)
    return rows


def roll_rows(rate: float, gpu: str) -> list:
    sms = sm_count(torch.device("cuda"))
    cases = _floors_inputs("floor_roll")
    want = [plain_floors.roll_plain(*a) for a in cases]
    planes, nrk, cbw, trips = check.ROLL_DEFAULT
    planned = floors.roll_plan(planes, nrk, cbw, trips, sms)
    rows = []
    for r in floors.ROLL_ROWS:
        for splits in floors.ROLL_SPLITS:
            plan = floors.roll_plan(planes, nrk, cbw, trips, sms, r, splits)
            run = [lambda a=a, p=plan: floors.run_roll(a[0], a[1], p) for a in cases]
            mark = " (plan)" if plan == planned else ""
            _candidate(rows, {"kernel": "floor_roll", "rows_a_thread": r, "splits": splits,
                              "groups_a_block": plan.groups_b, "blocks": plan.blocks,
                              "threads": plan.threads, "smem": plan.smem,
                              "planned": plan == planned, "launches": 1}, run, want, rate, gpu,
                       f"{r} rows a thread, {splits:2d} threads a word: {plan.blocks} blocks "
                       f"of {plan.threads} threads ({plan.groups_b} row groups){mark}")
            twice = floors.roll_plan(planes, nrk, cbw, 2 * trips, sms, r, splits)
            a = cases[0]
            rows[-1]["twice_trips_ms"] = ms = queued_ms(
                lambda: floors.run_roll(a[0], a[1], twice), 20, rate)
            print(f"floor_roll candidate {r} rows a thread, {splits:2d} threads a word at "
                  f"{2 * trips} trips: {ms:.4f} ms on {gpu}", flush=True)
    return rows


def _host_ms(call, seed, scan_len: int = 10, reps: int = 3) -> float:
    """Device ms a ``call`` from CUDA events recorded by the host around
    reps x scan_len chained calls after scan_len warm-up calls: the
    launches' host cost shows where it exceeds the kernel's."""
    out = seed
    for _ in range(scan_len):
        out = call(out)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps * scan_len):
        out = call(out)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * scan_len)


def _queued_chain_ms(call, seed, rate: float, n: int = 30) -> float:
    """Device ms a ``call`` of n chained calls queued behind a spin kernel."""
    box = [seed]

    def one():
        box[0] = call(box[0])

    return queued_ms(one, n, rate)


def rate_rows(rate: float, gpu: str) -> list:
    """The reference rates at their defaults (measure_taa_row_rate,
    measure_roll_rate at check.ROLL_DEFAULT, measure_sweep_rate), each
    timed from the host and on the device."""
    dev = torch.device("cuda")
    planes, n_idx, reps, trips = check.TAA_DEFAULT
    seed, idx, op = plain_floors.taa_inputs(planes, n_idx, reps, device=dev)
    taa = (lambda c: floors.taa(c, idx, op, trips, reps), seed,
           trips * reps * n_idx * planes * plain_floors.ROWS / 1e3, "rows/us")
    rp, nrk, cbw, rtrips = check.ROLL_DEFAULT
    rseed, rop = plain_floors.roll_inputs(rp, nrk, cbw, device=dev)
    roll = (lambda c: floors.roll(c, rop, rtrips), rseed, rtrips * 1e3, "rolls/s")
    chunks, sweeps, h, w = check.SWEEP_DEFAULT
    sseed, x = plain_floors.sweep_inputs(h, w, device=dev)
    sweep = (lambda c: floors.sweep(c, x, chunks, sweeps), sseed,
             chunks * sweeps * h * w / 1e6, "G cell-sweeps/s")
    rows = []
    for name, (call, s0, per_ms, unit) in (("floor_taa", taa), ("floor_roll", roll),
                                           ("floor_sweep", sweep)):
        host, device = _host_ms(call, s0), _queued_chain_ms(call, s0, rate)
        rows.append({"kernel": name, "host_ms": host, "device_ms": device,
                     "host_rate": per_ms / host, "device_rate": per_ms / device, "unit": unit})
        print(f"{name} rate from the host {per_ms / host:.1f} {unit} ({host:.4f} ms a call), "
              f"on the device {per_ms / device:.1f} {unit} ({device:.4f} ms a call) on {gpu}",
              flush=True)
    return rows


SECTIONS = ("stencil", "jacobi", "bloom", "display", "sunrays", "floors", "rates")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--json", default=None)
    ap.add_argument("--only", default=",".join(SECTIONS[:-1]),
                    help=f"comma-separated sections of {SECTIONS}")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if only - set(SECTIONS):
        ap.error(f"unknown sections {sorted(only - set(SECTIONS))}; of {SECTIONS}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_candidates measures a CUDA GPU and none is available")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    rate = spin_rate()
    rows = []
    if "stencil" in only:
        rows += stencil_rows(rate, gpu)
    if "jacobi" in only:
        rows += jacobi_rows(args.iters, rate, gpu)
    if "bloom" in only:
        rows += bloom_rows(rate, gpu) + bloom_batch_rows(rate, gpu)
    if "display" in only:
        rows += display_rows(rate, gpu) + threshold_rows(rate, gpu) + direct_rows(rate, gpu)
    if "sunrays" in only:
        rows += sunrays_rows(rate, gpu)
    if "floors" in only:
        rows += sweep_rows(rate, gpu) + taa_rows(rate, gpu) + roll_rows(rate, gpu)
    rates = rate_rows(rate, gpu) if "rates" in only else []
    sms = sm_count(torch.device("cuda"))
    chosen = {name: jacobi.plan(h, w, args.iters, sms) for name, h, w, _ in GRIDS}
    print(f"jacobi plan on {sms} SMs: {chosen}")
    tiles = {name: stencil.TILES[stencil.plan(h, w, sms)] for name, h, w, _ in STENCIL_GRIDS}
    print(f"pre_pressure plan on {sms} SMs: {tiles}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"gpu": gpu, "rows": rows, "rates": rates, "jacobi_plan": chosen,
                       "pre_pressure_plan": {k: str(v) for k, v in tiles.items()}}, f, indent=1)
    bad = [r for r in rows if r["max_abs_err"] != 0.0]
    if bad:
        raise AssertionError(f"candidates that differ from their plain version: {bad}")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
