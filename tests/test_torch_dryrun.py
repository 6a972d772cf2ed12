"""The port's dry run (tpufluid_torch/dryrun.py) and fidelity-drift tool
(tpufluid_torch/tools/fidelity_drift.py) on the CPU.

dryrun_multichip(8) on ["cpu"] * 8 runs every certification of
__graft_entry__.dryrun_multichip at its geometries and tolerances through
the plain passes; entry()'s step is held to JAX's entry() step (1e-4 of
the scale after one step, tests/test_torch_step.py's one-step class). The
drift tool runs small (60 steps at 32^2) and must give finite summaries
under the JAX tool's keys, with the JAX tool's constants and its rel_l2.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from tpufluid_torch import dryrun
from tpufluid_torch.interop import state_to_numpy
from tpufluid_torch.tools import fidelity_drift

REPO = Path(__file__).resolve().parents[1]
SUMMARY_KEYS = {"final", "vel_rel_l2_at_100", "max_abs_ke_rel_diff", "max_abs_dye_mass_rel_diff"}
RECORD_KEYS = {"variant", "step", "vel_rel_l2", "dye_rel_l2", "ke_rel_diff", "dye_mass_rel_diff"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch intra-op thread for this module: the suite runs files in
    parallel workers, and each worker's full thread pool oversubscribes the
    cores (these tests ran 20x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_fidelity_drift",
                                                  REPO / "tools" / "fidelity_drift.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dryrun_multichip_passes_on_8_cpu_devices():
    """Every certification passes: the sharded step within 2e-4 on 4x2 and
    8x1, the sharded kernels' call equal to the plain passes', batch DP and
    its K = 3 tick bit-equal, batch x spatial within 4e-4 on (2, 2, 2)."""
    out = dryrun.dryrun_multichip(8, devices=["cpu"] * 8)
    assert set(out["sharded"]) == {"4x2", "8x1"}
    for errs in out["sharded"].values():
        assert max(errs.values()) < 2e-4
    assert out["kernels_sharded"]["max_abs_err"] == 0.0
    assert out["batch_dp"]["max_abs_err"] == 0.0
    assert max(out["batch_spatial"].values()) < 4e-4


def test_dryrun_multichip_needs_a_gpu_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(ValueError, match="devices"):
        dryrun.dryrun_multichip(4, devices=["cpu"] * 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.entry()


def test_entry_step_matches_jax_entry():
    """entry(): the flagship 128/512 config's first step (swirl_trace seed
    0, dt 1/60) within 1e-4 of the scale of JAX's entry() step."""
    fn, args = dryrun.entry("cpu")
    assert args[0].velocity.shape == (2, 128, 128) and args[0].dye.shape == (3, 512, 512)
    got = state_to_numpy(fn(*args))
    jfn, jargs = jax_entry.entry()
    np.testing.assert_array_equal(np.asarray(jargs[2]), args[2].numpy())
    want = jfn(*jargs)
    for g, w in zip(got, (want.velocity, want.dye, want.pressure)):
        w = np.asarray(w, np.float32)
        assert float(np.abs(g - w).max()) <= 1e-4 * max(float(np.abs(w).max()), 1e-3)


def test_fidelity_drift_small_run_is_finite_with_jax_keys():
    jax_tool = _jax_tool()
    for name in ("STEPS", "RECORD_EVERY", "SIM", "DYE", "PERTURB_AT"):
        assert getattr(fidelity_drift, name) == getattr(jax_tool, name), name
    records = []
    summary = fidelity_drift.run(steps=60, sim=32, dye=32, device="cpu", records=records)
    assert set(summary) == {"f32_eps", "bf16_rgb9e5", "bf16_plain", "f16"}
    for name, s in summary.items():
        assert set(s) == SUMMARY_KEYS, name
        assert set(s["final"]) == RECORD_KEYS and s["final"]["step"] == 60
        values = [v for k, v in s.items() if k != "final"]
        values += [v for k, v in s["final"].items() if k not in ("variant", "step")]
        assert all(math.isfinite(v) for v in values), (name, s)
    # The butterfly baseline really was perturbed, and drifts less than
    # the 16-bit modes at this horizon.
    assert 0.0 < summary["f32_eps"]["final"]["vel_rel_l2"] \
        < summary["f16"]["final"]["vel_rel_l2"]
    assert len(records) == 4 * 6 and {r["step"] for r in records} == {10, 20, 30, 40, 50, 60}
    assert summary["f32_eps"]["vel_rel_l2_at_100"] == summary["f32_eps"]["final"]["vel_rel_l2"]


def test_fidelity_drift_rel_l2_equals_jax():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    assert fidelity_drift.rel_l2(a, b) == _jax_tool().rel_l2(a, b)
    zero = np.zeros_like(b)
    assert fidelity_drift.rel_l2(a, zero) == _jax_tool().rel_l2(a, zero)
