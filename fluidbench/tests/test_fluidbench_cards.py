"""A cell over several devices: the sharded entry run whole on a mesh of CPU
devices (correct, every step metric read; not correct with its halo
exchange left out, or with the control in its place), each card's window in
a device trace of two cards, one card's digest as it was before cards were
counted, and the banded reference against the whole grid's, bit for bit."""

import io
import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidbench import control, devtrace, harness, meshrun, metrics, program, rehearse, work
from fluidbench.devtrace import Event
from fluidbench.reference import banded, fluid, geometry

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
SEED = 2 ** 31 + 23


def sharded_cell():
    return meshrun.meshed(harness.load_cell("grid4096_bf16.steps"), (2, 2))


def quiet(cell, make_program=None):
    return rehearse.rehearse(cell, seed=SEED, seconds=0.2, make_program=make_program,
                             log=io.StringIO())


@pytest.mark.parametrize("budget", [None, 1], ids=["one_band", "a_band_a_row"])
def test_sharded_rehearsal_is_correct_and_reads_every_step_metric(monkeypatch, budget):
    if budget is not None:
        monkeypatch.setattr(banded, "BUDGET_BYTES", budget)
    cell = sharded_cell()
    r = quiet(cell)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert 0 < r["checks"]["state_err"]["value"] <= r["checks"]["state_err"]["limit"]
    want = {m["name"] for m in cell.per_layer if not m["name"].startswith("roofline_pct.")}
    assert want and want <= set(r["metrics"])
    assert r["device"]["count"] == 1 and r["device"]["busy_s_per_device"] == [r["device"]["busy_s"]]


def test_a_sharded_run_with_its_halo_exchange_left_out_is_not_correct(monkeypatch):
    """Every ghost strip a shard receives from another shard is zeros."""
    import tpufluid_torch.parallel.halo as halo

    monkeypatch.setattr(halo, "_send", lambda x, device: torch.zeros_like(x, device=device))
    r = quiet(sharded_cell())
    assert r["correct"] is False
    assert r["checks"]["state_err"]["value"] > r["checks"]["state_err"]["limit"]


def test_the_control_of_a_sharded_cell_is_not_correct():
    r = quiet(sharded_cell(), make_program=control.Control)
    assert r["correct"] is False


def test_the_sharded_state_is_made_a_block_a_device_and_read_by_rows():
    cell = sharded_cell()
    cfg = rehearse.shrink(cell.cfg)
    from fluidbench.traffic.generator import generate

    traffic = generate(rehearse.shrink_mix(cell.mix), cfg, SEED)
    prog = program.Program(cfg, rehearse.shrink_mix(cell.mix), traffic, ["cpu"] * 4)
    state, _ = prog.call(prog.init(), 0)
    assert len(state) == 2 and all(len(row) == 2 for row in state)
    assert state[0][0].velocity.shape[-2:] == (12, 12) and state[0][0].dye.shape[-2:] == (24, 24)
    whole = program.fields(state)
    part = program.fields(state, {"velocity": (5, 17), "pressure": (5, 17), "dye": (10, 34)})
    assert whole["dye"].shape == (1, 3, 48, 48)
    for k, rows in (("velocity", (5, 17)), ("pressure", (5, 17)), ("dye", (10, 34))):
        assert torch.equal(part[k], whole[k][..., rows[0]:rows[1], :])
    copy = harness.copy_into(harness.like(state), state)
    assert torch.equal(program.fields(copy)["dye"], whole["dye"])


def two_cards():
    """Two cards, two steps, each card's markers at its own times: card 0
    runs a pre_pressure, a jacobi_chunk and a copy to card 1; card 1 an
    advect_dye and a PyTorch kernel; a host sync between the steps."""
    ev = [Event("spin_kernel", True, 0.0, 1.0, 0), Event("spin_kernel", True, 5.0, 1.0, 1)]
    t = 10.0
    for _ in range(2):
        for card, name, dur in ((0, "void pre_pressure_kernel<float>(...)", 5.0),
                                (0, "void jacobi_chunk_kernel<float>(...)", 10.0),
                                (0, "Memcpy PtoP (Device -> Device)", 4.0),
                                (1, "void advect_dye_kernel<float, 3>(...)", 20.0),
                                (1, "void at::native::elementwise_kernel<128, 4>(...)", 6.0)):
            ev.append(Event(name, True, t, dur, card))
            t += dur
        ev.append(Event("cudaStreamSynchronize", False, t, 20.0))
        t += 20.0
    ev += [Event("spin_kernel", True, t, 1.0, 0), Event("spin_kernel", True, t + 3.0, 1.0, 1)]
    return devtrace.digest(ev, 2, "step"), t


def test_a_trace_of_two_cards_has_each_cards_window():
    d, t = two_cards()
    assert d.cards == [0, 1]
    assert d.extra["windows"] == {0: (1.0, t), 1: (6.0, t + 3.0)}
    assert d.window_us == pytest.approx(((t - 1.0) + (t - 3.0)) / 2)
    assert d.busy_us(0) == pytest.approx(2 * 19.0) and d.busy_us(1) == pytest.approx(2 * 26.0)
    assert d.busy_us() == pytest.approx(45.0)
    for c in d.cards:
        lo, hi = d.extra["windows"][c]
        assert sum(b - a for a, b in d.gaps(c)) == pytest.approx(hi - lo - d.busy_us(c))
    cfg = json.loads((CONFIGS / "grid4096_bf16.json").read_text())
    ctx = {"digest": d, "shape": work.Shape(cfg, 1, 2, 1, 1.0, 0),
           "peaks": {"bytes_per_s": 3.35e12, "flops_per_s": 67e12},
           "spans": {"host_s": 0.0, "units": 2, "window_s": 200e-6}}
    assert metrics.read("launches.step", ctx) == 4                 # 2 + 2 a step, summed
    assert metrics.read("torch_ops_ms.step", ctx) == pytest.approx(0.006)
    assert metrics.read("copy_ms.step", ctx) == pytest.approx(0.004)
    assert metrics.read("idle_pct.step", ctx) == pytest.approx(100 * (1 - 45.0 / 2 / 100.0))
    bound = sum(max(b / 3.35e12, f / 67e12)
                for b, f in (work.pass_work(p, ctx["shape"]) for p in work.passes()))
    assert metrics.read("mfu_roofline.step", ctx) == pytest.approx(100 * bound / (2 * 100e-6))
    b = devtrace.breakdown(d)
    ops = dict(b["device_ops"])
    assert ops["cuda:1 advect_dye_kernel"] == pytest.approx(40e-6)
    assert ops["cuda:0 Memcpy PtoP (Device -> Device)"] == pytest.approx(8e-6)
    assert all(k.startswith(("cuda:0 ", "cuda:1 ")) for k in dict(b["idle_gaps"]))


def test_a_card_without_both_markers_is_refused():
    ev = [Event("spin_kernel", True, 0.0, 1.0, 0), Event("spin_kernel", True, 9.0, 1.0, 0),
          Event("spin_kernel", True, 2.0, 1.0, 1), Event("advect_kernel", True, 4.0, 1.0, 1)]
    with pytest.raises(RuntimeError, match="card 1"):
        devtrace.digest(ev, 1, "step")


def parent_readings(events):
    """What the digest read before it counted cards (one stream, one pair of
    markers), frozen: the window, busy time and gaps."""
    marks = sorted((e for e in events if e.device and "spin_kernel" in e.name),
                   key=lambda e: e.start)
    lo, hi = marks[0].start + marks[0].dur, marks[1].start
    dev = [e for e in events if e.device and lo <= e.start < hi and "spin_kernel" not in e.name]
    spans = sorted((e.start, e.start + e.dur) for e in dev)
    busy, end = 0.0, None
    for a, b in spans:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    gaps, t = [], lo
    for a, b in spans:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return hi - lo, busy, gaps, len(dev)


@pytest.mark.parametrize("seed", range(5))
def test_one_cards_digest_is_the_parents(seed):
    rng = random.Random(seed)
    t, ev = 0.0, [Event("spin_kernel", True, 3.0, 1.5, 0)]
    for _ in range(200):
        t += rng.choice([0.0, 0.5, 3.0, 11.0])
        ev.append(Event(rng.choice(["void advect_kernel<float>(x)", "Memset (Device)",
                                    "Memcpy HtoD (Pageable -> Device)"]), True, t,
                        rng.uniform(0.1, 9.0), 0))
        ev.append(Event("cudaLaunchKernel", False, t - 2.0, 1.0))
    ev.append(Event("spin_kernel", True, t + 4.0, 1.5, 0))
    ev.append(Event("advect_kernel", True, t + 9.0, 2.0, 0))          # after the window
    d = devtrace.digest(ev, 7, "step")
    window, busy, gaps, n = parent_readings(ev)
    assert d.window_us == window and d.busy_us() == busy and d.gaps() == gaps
    assert len(d.device) == n and d.cards == [0]
    assert all(not k.startswith("cuda:") for k, _ in devtrace.breakdown(d)["device_ops"])


def tiny(sim, dye):
    cfg = json.loads((CONFIGS / "grid4096_bf16.json").read_text())
    return dict(cfg, SIM_RESOLUTION=sim, DYE_RESOLUTION=dye, CANVAS_WIDTH=max(sim, dye),
                CANVAS_HEIGHT=max(sim, dye))


def whole_and_banded(cfg, keep, margin, steps=1):
    """fluid.step over the whole grid, and its bands' kept rows put
    together, from the same seeded fields and splats."""
    g = torch.Generator().manual_seed(7)
    (sh, sw), (dh, dw) = geometry.sizes(cfg)["sim"], geometry.sizes(cfg)["dye"]
    f = {"velocity": 300 * torch.randn((1, 2, sh, sw), generator=g),
         "dye": torch.rand((1, 3, dh, dw), generator=g),
         "pressure": torch.randn((1, sh, sw), generator=g)}
    splats = torch.rand((steps, 1, cfg["MAX_SPLATS"], 8), generator=g)
    splats[..., 2:4] = 1000 * (splats[..., 2:4] - 0.5)
    store = fluid.storage(cfg["DTYPE"])
    dts = np.full((1,), 1 / 60, np.float32)

    def chunk(x, row0=None):
        for k in range(steps):
            x = fluid.step(x, dts, splats[k], cfg, store, True, row0)
        return x

    whole = chunk(f)
    bands = banded.bands(cfg, keep, margin)
    read = lambda rows: {k: x[..., rows[k][0]:rows[k][1], :] for k, x in f.items()}  # noqa: E731
    parts = list(banded.run(read, chunk, bands))
    got = {k: torch.cat([p[k] for _, p in parts], dim=-2) for k in whole}
    return whole, got, bands


@pytest.mark.parametrize("grid", [(256, 256), (128, 256)], ids=["same", "dye2x"])
def test_the_banded_reference_is_the_whole_grids_bit_for_bit(grid):
    cfg = tiny(*grid)
    margin = banded.reach(cfg)
    assert margin == 20 + 3 + 1 + 2 * 18
    sh = grid[0]
    whole, got, bands = whole_and_banded(cfg, sh // 4, margin)
    assert len(bands) == 4 and bands[1].run == (max(0, sh // 4 - margin), sh // 2 + margin)
    for k in whole:
        assert float(whole[k].abs().max()) > 0
        assert torch.equal(got[k], whole[k]), k


def test_a_margin_short_of_the_sweeps_reach_is_not_the_whole_grid():
    whole, got, _ = whole_and_banded(tiny(256, 256), 64, 10)
    assert not torch.equal(got["pressure"], whole["pressure"])


def test_a_chunks_margin_is_its_steps_reach_and_bands_follow_the_budget():
    cfg = json.loads((CONFIGS / "grid4096_bf16.json").read_text())
    cut = dict(cfg, SIM_RESOLUTION=32768, DYE_RESOLUTION=32768, CANVAS_WIDTH=32768,
               CANVAS_HEIGHT=32768)
    bands = banded.plan(cut, 10)
    assert bands[1].keep[0] - bands[1].run[0] == 600 < 640
    row_bytes = banded.BYTES_PER_TEXEL * 32768
    run = bands[1].run[1] - bands[1].run[0]
    assert run * row_bytes <= banded.BUDGET_BYTES < (run + 1) * row_bytes
    assert bands[0].run[0] == 0 and bands[-1].keep[1] == bands[-1].run[1] == 32768
    assert [b.keep[0] for b in bands[1:]] == [b.keep[1] for b in bands[:-1]]
    assert len(banded.plan(cfg, 10)) == 1                               # 4096^2: one band
    with pytest.raises(ValueError):
        banded.bands(tiny(256, 128), 3, 60)                              # half a dye row


def test_meshrun_needs_the_cards_it_names_and_prints_nothing():
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root = Path(__file__).resolve().parents[2]
    p = subprocess.run([sys.executable, "-m", "fluidbench.meshrun", "--workload",
                        "grid4096_bf16.steps", "--mesh", "2x2", "--devices", "0,1,2,3", "--seed",
                        str(SEED), "--seconds", "1"], cwd=root, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 2 and p.stdout.strip() == "" and "CUDA" in p.stderr
