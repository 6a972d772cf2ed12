"""The frozen work models against the program's own (ops/cuda/check.py's
Case.nbytes and flops): at the four cells' shapes, with the plain passes
replaced by shape-only stand-ins so that no 4096^2 field is computed here,
and at a tiny shape on real tensors, where each input and output of a pass
is read or written once."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidbench import program, work
from fluidbench.rehearse import shrink
from fluidbench.traffic.generator import generate, load

HERE = Path(__file__).resolve().parents[1]
PASSES = {"pre_pressure": "pre_pressure", "jacobi_project": "projection",
          "advect:velocity": "velocity_advection", "advect:dye": "dye_advection",
          "bloom_pyramid": "bloom", "display": "display"}


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def fake_plain(monkeypatch):
    """Shape-only stand-ins for the plain passes check.py runs to lay out a
    step's and a frame's cases."""
    from tpufluid_torch.ops.cuda import advect, bloom, check, jacobi, stencil

    def pre(vel, curl, dt, vf=None, **kw):
        return torch.empty_like(vel), torch.empty(vel.shape[:-3] + vel.shape[-2:], dtype=vel.dtype)

    monkeypatch.setattr(stencil, "pre_pressure_plain", pre)
    monkeypatch.setattr(jacobi, "jacobi_project_plain",
                        lambda p, d, v, *a, **k: (torch.empty_like(p), torch.empty_like(v)))
    monkeypatch.setattr(advect, "advect_plain", lambda v, s, *a, **k: torch.empty_like(s))
    monkeypatch.setattr(check, "resample_bilinear",
                        lambda x, hw: torch.empty(x.shape[:-2] + tuple(hw), dtype=x.dtype))
    monkeypatch.setattr(check, "apply_sunrays",
                        lambda x, hw, w: torch.empty(x.shape[:-3] + tuple(hw), dtype=x.dtype))
    monkeypatch.setattr(bloom, "bloom_pyramid_plain", lambda b, *a: torch.empty_like(b))


def zero_state(cfg, sims, batched):
    c = program.fluid_config(cfg)
    (sw, sh), (dw, dh) = c.sim_size, c.dye_size
    lead = (sims,) if batched else ()
    from tpufluid_torch.state import FluidState

    return FluidState(*(torch.empty(lead + s, dtype=c.dtype)
                        for s in ((2, sh, sw), (3, dh, dw), (sh, sw))))


def program_counts(cfg, state, splats, dt, frames):
    """{pass: (bytes, operations)} of one step (and frame) by check.py."""
    from tpufluid_torch.ops.cuda import check

    c = program.fluid_config(cfg)
    cases = [x for x in check.step_cases(state, torch.from_numpy(splats), c, dt)
             if x.label in PASSES]
    if frames:
        cases += check.render_cases(state, c)
    return {PASSES[x.label]: (x.nbytes, x.flops) for x in cases}


def model_counts(cfg, sims, item, steps, active, frames):
    s = work.Shape(cfg, sims, item, steps, active, frames)
    return {p: work.pass_work(p, s) for p in work.passes()}


CELLS = [("grid4096_bf16", "steps"), ("webgl_default_f32", "fleet16"),
         ("webgl_default_f32", "fleet16_ff4")]


@pytest.mark.parametrize("conf,mix_name", CELLS)
def test_models_equal_the_programs_counts_at_the_cells_shapes(monkeypatch, conf, mix_name):
    fake_plain(monkeypatch)
    cfg, mix = config(conf), load(mix_name)
    traffic = generate(mix, cfg, 2 ** 31 + 17)
    sims, batched = mix["sims"], mix["entry"] != "multi_step"
    state = zero_state(cfg, sims, batched)
    item = state.velocity.element_size()
    frames = int(mix["entry"] == "tick")
    k = int(traffic.substeps.max())
    # A unit: the traffic's first row, then (fast-forward) k - 1 substeps
    # without splats, each with the dts its sims have there.
    rows = [traffic.splats[0]] + [np.zeros_like(traffic.splats[0])] * (k - 1)
    want: dict = {}
    for i, r in enumerate(rows):
        dts = np.where(i < traffic.substeps, traffic.dts[0], 0.0).astype(np.float32)
        dt = dts if batched else dts[0]
        got = program_counts(cfg, state, r if batched else r[0], dt, frames and i == 0)
        for p, (b, f) in got.items():
            wb, wf = want.get(p, (0, 0))
            want[p] = (wb + b, wf + f)
    active = float((traffic.splats[0][..., 7] != 0).sum())
    have = model_counts(cfg, sims, item, k, active, frames)
    assert {p: v for p, v in have.items() if v != (0, 0)} == want


def test_models_count_each_input_and_output_once_on_real_tensors():
    """At a tiny shape the plain passes run for real: the bytes of what
    each pass reads and writes, each tensor once, are the model's."""
    from tpufluid_torch.ops.cuda import check

    cfg = shrink(config("webgl_default_f32"))
    c = program.fluid_config(cfg)
    sims = 3
    traffic = generate(dict(load("fleet16"), sims=sims, length=4), cfg, 3)
    from tpufluid_torch.batch import init_batch

    state = init_batch(c, sims, device="cpu")
    splats = torch.from_numpy(traffic.splats[1])
    cases = {x.label: x for x in check.step_cases(state, splats, c, 1 / 60)}
    cases.update({x.label: x for x in check.render_cases(state, c)})
    have = model_counts(cfg, sims, 4, 1, float((splats[..., 7] != 0).sum()), 1)
    for label, p in PASSES.items():
        x = cases[label]
        assert have[p] == (x.nbytes, x.flops), label
    vel, dye, p = state.velocity, state.dye, state.pressure
    # The projection reads the pressure, the divergence and the velocity
    # and writes the pressure and the velocity: 7 sim fields' worth.
    assert have["projection"][0] == 7 * p.numel() * 4
    assert have["velocity_advection"][0] == 2 * vel.numel() * 4


def test_every_program_kernel_maps_to_a_pass_with_a_model():
    names = {p.stem: json.loads(p.read_text())["pass"] for p in (HERE / "work" / "kernels").glob("*.json")}
    assert set(names.values()) <= set(work.passes())
    for stem in ("pre_pressure_kernel", "jacobi_chunk_kernel", "jacobi_project_kernel",
                 "advect_kernel", "advect_dye_kernel", "bloom_pyramid_kernel", "display_kernel"):
        assert work.kernel_pass(stem) is not None
    assert work.kernel_pass("elementwise_kernel") is None
