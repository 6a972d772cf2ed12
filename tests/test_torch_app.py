"""The port's headless app (tpufluid_torch.app) on the CPU
(TPUFLUID_DEVICE=cpu): its options against tpufluid.app's, the CLI smoke
run of tests/test_aux.py, its final state against make_multi_step and
against its own resumed run (bit for bit), against the JAX app's checkpoint
(the port's step tolerance), and the dither texture through
make_step_and_render.

Tolerances: bit for bit within the port (the same kernels' plain versions
on the same inputs in the same order); against JAX after 3 float32 steps
1e-3 of the field's scale, the bound of tests/test_torch_step.py; uint8
frames at most 1 count on few pixels, as tests/test_torch_render.py.
"""

import argparse
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufluid.app as japp
import tpufluid.checkpoint as jckpt
from tpufluid import FluidConfig as JaxConfig
from tpufluid import init_state as jax_init
from tpufluid.render import make_step_and_render as jax_make_step_and_render
from tpufluid.trace import swirl_trace as jax_trace
import tpufluid_torch.app as tapp
from tpufluid_torch import FluidConfig, init_state, make_multi_step, make_step_and_render, spans
from tpufluid_torch.checkpoint import load_state
from tpufluid_torch.interop import config_from_dict, state_to_numpy
from tpufluid_torch.trace import Trace, swirl_trace

SMALL = ["--sim-res", "24", "--dye-res", "32", "--canvas", "64x48", "--jacobi-iters", "4"]


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("TPUFLUID_DEVICE", "cpu")


def _actions(parser):
    return {a.dest: a for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def test_argparser_options_and_defaults_equal_jax():
    got, want = _actions(tapp.build_argparser()), _actions(japp.build_argparser())
    assert set(got) == set(want)
    for dest, w in want.items():
        g = got[dest]
        assert (g.option_strings, g.default, g.type, g.choices, type(g), g.nargs) == \
            (w.option_strings, w.default, w.type, w.choices, type(w), w.nargs), dest
    assert "not per pass" in got["debug_nans"].help


def test_app_cli_smoke(tmp_path, cpu):
    out = str(tmp_path / "run")
    tapp.main(["--steps", "12", "--sim-res", "24", "--dye-res", "24", "--canvas", "48x48",
               "--render-every", "6", "--metrics-every", "6", "--ckpt-every", "12",
               "--out", out, "--jacobi-iters", "4"])
    files = os.listdir(out)
    assert "metrics.jsonl" in files
    assert any(f.startswith("frame_") for f in files)
    assert any(f.startswith("ckpt_") for f in files)
    recs = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in recs] == [6, 12] and all(r["nonfinite"] == 0 for r in recs)


def test_cli_all_gui_knobs(tmp_path, cpu):
    """Every control-panel knob has a flag and reaches the config (read
    back from the app's checkpoint); the capture, GIF and profile land."""
    out = str(tmp_path / "run")
    tapp.main([*SMALL, "--steps", "4", "--out", out, "--ckpt-every", "4",
               "--density-dissipation", "2", "--velocity-dissipation", "0.5",
               "--pressure", "0.6", "--vorticity", "50", "--splat-radius", "0.5",
               "--bloom-intensity", "1.2", "--bloom-threshold", "0.3",
               "--sunrays-weight", "0.7", "--back-color", "10,20,30", "--transparent",
               "--no-colorful", "--render-every", "2", "--gif", "x",
               "--capture", str(tmp_path / "cap.png"), "--profile", str(tmp_path / "prof"),
               "--dtype", "bfloat16", "--debug-nans"])
    _, cfg, step, _ = load_state(os.path.join(out, "ckpt_000004.npz"), device="cpu")
    assert step == 4 and cfg.DTYPE == "bfloat16"
    assert (cfg.DENSITY_DISSIPATION, cfg.VELOCITY_DISSIPATION, cfg.PRESSURE, cfg.CURL,
            cfg.SPLAT_RADIUS, cfg.BLOOM_INTENSITY, cfg.BLOOM_THRESHOLD,
            cfg.SUNRAYS_WEIGHT) == (2.0, 0.5, 0.6, 50.0, 0.5, 1.2, 0.3, 0.7)
    assert cfg.BACK_COLOR == (10, 20, 30) and cfg.TRANSPARENT and not cfg.COLORFUL
    assert os.path.exists(os.path.join(out, "run.gif")) and os.path.exists(tmp_path / "cap.png")
    assert os.path.exists(tmp_path / "prof" / "trace.json")
    # The trace carries the port's spans (tpufluid_torch.spans) as its
    # ranges: 4 steps and 2 frames with their passes, nothing else named.
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    ranges = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert ranges.count("step") == 4 and ranges.count("frame") == 2
    assert {"upload", "splat_factors", "pre_pressure", "projection", "velocity_advection",
            "dye_advection", "dye_cast", "bloom_resample", "bloom_pyramid", "sunrays",
            "display", "backdrop", "blend"} <= set(ranges)
    assert "fluid_step" not in ranges and "render" not in ranges
    assert spans.recorder() is None


def test_app_final_state_equals_make_multi_step(tmp_path, cpu):
    out = str(tmp_path / "run")
    tapp.main([*SMALL, "--steps", "10", "--seed", "3", "--ckpt-every", "10",
               "--metrics-every", "0", "--out", out])
    got, cfg, _, _ = load_state(os.path.join(out, "ckpt_000010.npz"), device="cpu")
    trace = swirl_trace(cfg, 10, seed=3)
    want = make_multi_step(cfg, device="cpu")(init_state(cfg, device="cpu"), trace.dts,
                                              trace.batches)
    for g, w in zip(state_to_numpy(got), state_to_numpy(want)):
        np.testing.assert_array_equal(g, w)
    assert np.abs(state_to_numpy(got)[1]).max() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_app_resume_equals_straight_run(tmp_path, cpu, dtype):
    """A run resumed from the app's checkpoint at step 6 ends on the
    straight run's state, bit for bit; a recorded trace replays past its
    end at the dt clamp without splats."""
    trace_path = str(tmp_path / "trace.npz")
    cfg = FluidConfig(SIM_RESOLUTION=24, DYE_RESOLUTION=32, CANVAS_WIDTH=64,
                      CANVAS_HEIGHT=48).validate()
    swirl_trace(cfg, 9, seed=5).save(trace_path)
    args = [*SMALL, "--steps", "12", "--dtype", dtype, "--trace", trace_path,
            "--ckpt-every", "6", "--metrics-every", "0"]
    tapp.main([*args, "--out", str(tmp_path / "straight")])
    tapp.main([*args, "--out", str(tmp_path / "resumed"),
               "--resume", str(tmp_path / "straight" / "ckpt_000006.npz")])
    a, _, sa, _ = load_state(str(tmp_path / "straight" / "ckpt_000012.npz"), device="cpu")
    b, _, sb, _ = load_state(str(tmp_path / "resumed" / "ckpt_000012.npz"), device="cpu")
    assert sa == sb == 12 and not os.path.exists(tmp_path / "resumed" / "ckpt_000006.npz")
    for g, w in zip((b.velocity, b.dye, b.pressure), (a.velocity, a.dye, a.pressure)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert Trace.load(trace_path).num_steps == 9


def test_app_matches_the_jax_app(tmp_path, monkeypatch):
    """Both apps, 3 float32 steps of the same swirl trace, each writing its
    checkpoint: the fields within 1e-3 of their scale, the configs and
    step cursors equal."""
    monkeypatch.setenv("TPUFLUID_DEVICE", "cpu")
    args = [*SMALL, "--steps", "3", "--ckpt-every", "3", "--metrics-every", "0", "--seed", "2"]
    japp.main([*args, "--out", str(tmp_path / "jax")])
    tapp.main([*args, "--out", str(tmp_path / "port")])
    js, jcfg, jstep, _ = jckpt.load_state(str(tmp_path / "jax" / "ckpt_000003.npz"))
    ts, tcfg, tstep, _ = load_state(str(tmp_path / "port" / "ckpt_000003.npz"), device="cpu")
    assert jstep == tstep == 3 and dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    for g, w in zip(state_to_numpy(ts), (js.velocity, js.dye, js.pressure)):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max()


def test_app_needs_a_gpu_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    monkeypatch.delenv("TPUFLUID_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="TPUFLUID_DEVICE=cpu"):
        tapp.main([*SMALL, "--steps", "1", "--out", str(tmp_path / "run")])
    monkeypatch.setenv("TPUFLUID_DEVICE", "tpu")   # only "cpu" leads to the CPU
    with pytest.raises(RuntimeError, match="TPUFLUID_DEVICE=cpu"):
        tapp.main([*SMALL, "--steps", "1", "--out", str(tmp_path / "run")])


def test_debug_nans_stops_at_the_first_non_finite_step(tmp_path, cpu):
    """--debug-nans raises at the step after which a field is not finite:
    a NaN pressure in the resumed state spreads in the first step."""
    cfg = FluidConfig(SIM_RESOLUTION=24, DYE_RESOLUTION=32, CANVAS_WIDTH=64,
                      CANVAS_HEIGHT=48, PRESSURE_ITERATIONS=4).validate()
    state = init_state(cfg, device="cpu")
    state.pressure[3, 3] = float("nan")
    from tpufluid_torch.checkpoint import save_state

    path = str(tmp_path / "nan.npz")
    save_state(path, state, cfg, step=2)
    args = [*SMALL, "--steps", "5", "--resume", path, "--out", str(tmp_path / "run"),
            "--metrics-every", "0"]
    tapp.main(args)   # without the flag the run ends
    with pytest.raises(FloatingPointError, match="after step 3"):
        tapp.main([*args, "--debug-nans"])


def test_dither_png_through_make_step_and_render(tmp_path):
    """make_step_and_render(dither_path=...) reads the PNG once and matches
    JAX's tick with the same texture; frame_u8 with the path agrees."""
    from PIL import Image

    path = str(tmp_path / "d.png")
    Image.fromarray(np.random.default_rng(8).integers(0, 256, (40, 24), dtype=np.uint8),
                    "L").save(path)
    kw = dict(SIM_RESOLUTION=16, DYE_RESOLUTION=32, CANVAS_WIDTH=64, CANVAS_HEIGHT=48,
              BLOOM_RESOLUTION=16, SUNRAYS_RESOLUTION=16, MAX_SPLATS=4, USE_PALLAS=False)
    jcfg = JaxConfig(**kw).validate()
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    trace = jax_trace(jcfg, 1, seed=1)
    batch = trace.batches[0] * np.array([1, 1, 1, 1, 0.02, 0.02, 0.02, 1], np.float32)
    dt = np.float32(1 / 60)
    want_state, want = jax_make_step_and_render(jcfg, dither_path=path)(
        jax_init(jcfg), dt, jnp.asarray(batch))
    tick = make_step_and_render(cfg, dither_path=path, device="cpu")
    os.remove(path)   # read when the tick was made, not on each tick
    got_state, got = tick(init_state(cfg, device="cpu"), dt, batch)
    for g, w in zip(state_to_numpy(got_state), (want_state.velocity, want_state.dye,
                                                want_state.pressure)):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
    d = np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
    assert got.shape == want.shape and d.max() <= 1 and (d > 0).mean() < 1e-3
    plain = make_step_and_render(cfg, device="cpu")(init_state(cfg, device="cpu"), dt, batch)[1]
    assert not torch.equal(got, plain)
