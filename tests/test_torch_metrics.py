"""The port's run metrics (tpufluid_torch/metrics.py) and long-horizon tool
(tpufluid_torch/tools/long_horizon.py) against tpufluid's, on the CPU.

``diagnostics`` is held to tpufluid.metrics.diagnostics on one state stepped
by JAX and carried across with interop: every key within 1e-5 of its value
(both compute in float32 from the same fields; the sums reduce in another
order), the contract constant and the non-finite count equal.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpufluid import FluidConfig as JaxConfig
from tpufluid import init_state as jax_init
from tpufluid import metrics as jax_metrics
from tpufluid.step import fluid_step as jax_step
from tpufluid.trace import swirl_trace as jax_trace
from tpufluid_torch import metrics
from tpufluid_torch.interop import config_from_dict, state_from_numpy
from tpufluid_torch.tools import long_horizon

ROOT = Path(__file__).resolve().parents[1]


def _jax_state(dtype, steps=6):
    cfg = JaxConfig(SIM_RESOLUTION=48, DYE_RESOLUTION=96, CANVAS_WIDTH=192,
                    CANVAS_HEIGHT=128, MAX_SPLATS=4, DTYPE=dtype).validate()
    trace = jax_trace(cfg, steps, seed=3)
    s = jax_init(cfg)
    step = jax.jit(lambda st, dt, sp: jax_step(st, dt, sp, cfg))
    for t in range(steps):
        s = step(s, np.float32(1 / 60), jnp.asarray(trace.batches[t]))
    return cfg, s


def _carried(cfg, s):
    arrays = (np.asarray(x) for x in (s.velocity, s.dye, s.pressure))
    return config_from_dict(dataclasses.asdict(cfg)), state_from_numpy(*arrays, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_diagnostics_match_jax(dtype):
    cfg, s = _jax_state(dtype)
    want = jax_metrics.diagnostics(s, cfg)
    tcfg, ts = _carried(cfg, s)
    got = metrics.diagnostics(ts, tcfg)
    assert set(got) == set(want)
    assert all(isinstance(v, float) for v in got.values())
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-5 * max(abs(w), 1e-6), (k, got[k], w)
    assert got["halo_contract_speed"] == want["halo_contract_speed"]
    assert got["nonfinite"] == want["nonfinite"] == 0.0
    assert got["backtrace_speed"] > 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_halo_contract_speed_matches_jax(dtype):
    cfg = JaxConfig(DTYPE=dtype).validate()
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    assert metrics.halo_contract_speed(tcfg) == jax_metrics.halo_contract_speed(cfg)


def test_contract_warning_matches_jax():
    """The same condition and leading text; the tail says what the port's
    gather does past the contract, which is not what the TPU kernels do."""
    for back, halo in ((100.0, 1320.0), (1320.0, 1320.0), (1900.4, 1800.0)):
        rec = {"backtrace_speed": back, "halo_contract_speed": halo}
        got, want = metrics.contract_warning(rec), jax_metrics.contract_warning(rec)
        assert (got is None) == (want is None)
        if want is not None:
            assert got.split(";")[0] == want.split(";")[0]
    warn = metrics.contract_warning({"backtrace_speed": 2000.0, "halo_contract_speed": 1800.0})
    assert warn.startswith("backtrace speed 2000 texels/s exceeds the gather-halo contract "
                           "(1800);")
    assert "clamps only at the grid edge" in warn and "window edge" not in warn


def test_metrics_logger_jsonl(tmp_path):
    cfg, s = _jax_state("float32", steps=2)
    tcfg, ts = _carried(cfg, s)
    path = tmp_path / "metrics.jsonl"
    logger = metrics.MetricsLogger(str(path))
    first = logger.log(2, ts, tcfg, frame=7)
    logger.log(3, ts, tcfg)
    logger.close()
    assert logger.stream is None
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(lines) == 2 and lines[0] == first
    assert lines[0]["step"] == 2 and lines[0]["frame"] == 7 and lines[1]["step"] == 3
    want = {"step", "wall_s", *jax_metrics.diagnostics(s, cfg)}
    assert set(lines[1]) == want
    quiet = metrics.MetricsLogger()
    assert quiet.log(0, ts, tcfg)["step"] == 0


def test_long_horizon_summary_has_the_jax_keys(tmp_path):
    argv = ["--cpu", "--res", "32", "--steps", "60", "--splat-steps", "20", "--chunk", "10"]
    got = long_horizon.main(argv + ["--out", str(tmp_path / "port")])
    spec = importlib.util.spec_from_file_location("jax_long_horizon",
                                                  ROOT / "tools" / "long_horizon.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    want = tool.main(argv + ["--out", str(tmp_path / "jax")])
    assert set(got) == set(want)
    assert got["config"] == want["config"]
    assert json.loads((tmp_path / "port" / "summary.json").read_text()) == got
    assert len((tmp_path / "port" / "metrics.jsonl").read_text().splitlines()) == 6
    assert got["nonfinite_total"] == 0 and got["contract_warnings"] == 0
    assert got["halo_contract_speed"] == want["halo_contract_speed"] == 1800.0
    # 40 post-input steps are too few for the 4x decay the ok rule asks
    assert got["ok"] is want["ok"] is False
