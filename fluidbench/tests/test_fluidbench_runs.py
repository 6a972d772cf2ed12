"""Whole runs at a rehearsal's size on the CPU: each cell's run is correct;
the control (the reference in a lower precision in the program's place)
and the program broken underneath each come out not correct; and the chip
command refuses to run without a card."""

import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidbench import control, harness, rehearse

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SECONDS = 0.2


def quiet(name, make_program=None):
    return rehearse.rehearse(name, seed=2 ** 31 + 11, seconds=SECONDS, make_program=make_program,
                             log=io.StringIO())


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_is_correct_and_reads_its_metrics(name):
    r = quiet(name)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    cell = harness.load_cell(name)
    assert set(r["checks"]) == set(cell.limits)
    assert all(v["value"] == 0.0 for v in r["checks"].values())
    # Read on the CPU profiler's events, where the passes' kernels do not
    # run: every reader but the rooflines finds something.
    want = {m["name"] for m in cell.per_layer
            if not m["name"].startswith("roofline_pct.")}
    assert want <= set(r["metrics"])
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    r = quiet(name, make_program=control.Control)
    assert r["correct"] is False
    assert any(v["value"] > v["limit"] for v in r["checks"].values())


def _patch_step(monkeypatch, after):
    """Replace the program's step body (every module that bound it) by the
    real step followed by ``after(state_in, state_out)``."""
    import tpufluid_torch.batch as batch
    import tpufluid_torch.serve_batch as serve_batch
    import tpufluid_torch.step as step

    real = step._step

    def broken(state, dt, splats, config, passes):
        return after(state, real(state, dt, splats, config, passes))

    for m in (step, batch, serve_batch):
        monkeypatch.setattr(m, "_step", broken)


def _unchanged(state_in, state_out):
    return state_in


def _half_left_out(state_in, state_out):
    from tpufluid_torch.state import FluidState

    b = state_in.velocity.shape[0]
    return FluidState(*(torch.cat([getattr(state_out, f)[:b // 2], getattr(state_in, f)[b // 2:]])
                        for f in ("velocity", "dye", "pressure")))


def _altered(state_in, state_out):
    dye = state_out.dye.clone()
    dye.view(-1)[dye.numel() // 2] += 0.25
    return type(state_out)(state_out.velocity, dye, state_out.pressure)


FAULTS = {"unchanged": _unchanged, "half_left_out": _half_left_out, "altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_step_is_not_correct(monkeypatch, name, fault):
    if fault == "half_left_out" and harness.load_cell(name).mix["sims"] == 1:
        pytest.skip("one sim: the cell has no batch to leave half of")
    _patch_step(monkeypatch, FAULTS[fault])
    assert quiet(name)["correct"] is False


@pytest.mark.parametrize("name", [c for c in CELLS if harness.load_cell(c).unit == "tick"])
def test_an_altered_frame_is_not_correct(monkeypatch, name):
    import tpufluid_torch.render as render

    real = render._quantize

    def altered(frame):
        q = real(frame).clone()
        q[0] = 255 - q[0]       # one session's frame, where it is made
        return q

    monkeypatch.setattr(render, "_quantize", altered)
    r = quiet(name)
    assert r["correct"] is False
    assert r["checks"]["frame_mismatch_pct"]["value"] > r["checks"]["frame_mismatch_pct"]["limit"]


def test_the_chip_command_needs_a_card_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "-m", "fluidbench.run", "--workload", CELLS[0],
                        "--seed", str(2 ** 31 + 1), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_the_benchmark_alone_cannot_run(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files:
    the program is missing, so the run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in BENCH["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    code = ("import torch; torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; import sys; "
            "from fluidbench import run; sys.exit(run.main(['--workload', %r, '--seed', '3', "
            "'--seconds', '1']))" % CELLS[0])
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "tpufluid_torch" in p.stderr


def test_a_large_seed_gives_the_same_inputs():
    from fluidbench.traffic.generator import generate

    cell = harness.load_cell(CELLS[0])
    a = generate(cell.mix, cell.cfg, 2 ** 31 + 2 ** 20)
    b = generate(cell.mix, cell.cfg, 2 ** 31 + 2 ** 20)
    assert np.array_equal(a.splats, b.splats)


def test_frame_mismatch_is_the_worst_sessions_share():
    from fluidbench import check

    ref = torch.zeros((16, 10, 20, 3), dtype=torch.uint8)
    got = ref.clone()
    got[3].view(-1)[:24] = 1            # 4% of one session's values
    assert check.frame_mismatch_pct(got, ref) == pytest.approx(4.0)
    assert check.frame_mismatch_pct(ref, ref) == 0.0
    assert check.frame_mismatch_pct(got[:, :5], ref) == 100.0
