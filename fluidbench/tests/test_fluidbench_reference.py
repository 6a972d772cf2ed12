"""The reference against the program's CPU path (its kernels' plain
versions) at tiny sizes: the step of one sim and of a batch with a dt a
sim, in float32 and in bfloat16 with the RGB9E5 dye, the fast-forward
tick's substeps and select, and the fleet's frame; and the dither tile."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidbench import program
from fluidbench.reference import bluenoise, fluid, frame
from fluidbench.rehearse import shrink

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def tiny(name):
    return shrink(json.loads((CONFIGS / f"{name}.json").read_text()))


def traces(cfg, steps, sims, seed):
    from tpufluid_torch.trace import swirl_trace

    c = program.fluid_config(cfg)
    return np.stack([swirl_trace(c, steps, seed=seed + i).batches for i in range(sims)], 1)


def ref_steps(cfg, state, dts, splats):
    store, rgb = fluid.storage(cfg["DTYPE"]), cfg["DTYPE"] == "bfloat16" and cfg["DYE_RGB9E5"]
    f = program.fields(state)
    for t in range(len(dts)):
        f = fluid.step(f, dts[t], torch.from_numpy(splats[t]), cfg, store, rgb)
    return f


@pytest.mark.parametrize("name", ["webgl_default_f32", "grid4096_bf16"])
def test_batched_step_with_a_dt_a_sim_is_the_programs(name):
    from tpufluid_torch.batch import init_batch, make_batched_multi_step

    cfg = tiny(name)
    c = program.fluid_config(cfg)
    sims, steps = 3, 8
    splats = traces(cfg, steps, sims, 5)
    dts = np.tile(np.linspace(0.25, 1.0, sims, dtype=np.float32) / 60, (steps, 1))
    state = init_batch(c, sims, device="cpu")
    out = make_batched_multi_step(c, device="cpu")(state, dts, splats)
    ref = ref_steps(cfg, state, dts, splats)
    got = program.fields(out)
    for k in ref:
        assert float(ref[k].abs().max()) > 0
        assert torch.equal(got[k], ref[k]), k


def test_one_sim_multi_step_is_the_programs():
    from tpufluid_torch.step import make_multi_step

    cfg = tiny("grid4096_bf16")
    c = program.fluid_config(cfg)
    splats = traces(cfg, 6, 1, 9)
    state = program.Program.__new__(program.Program)
    state.config, state.entry, state.sims, state.device = c, "multi_step", 1, torch.device("cpu")
    zero = program.Program.init(state)
    out = make_multi_step(c, device="cpu")(zero, np.float32(1 / 60), splats[:, 0])
    ref = ref_steps(cfg, zero, np.full((6, 1), 1 / 60, np.float32), splats)
    for k, v in program.fields(out).items():
        assert torch.equal(v, ref[k]), k


@pytest.mark.parametrize("kind", ["scalar", 4])
def test_fleet_tick_state_and_frames_are_the_programs(kind):
    from tpufluid_torch.batch import make_batched_multi_step
    from tpufluid_torch.serve_batch import make_tick_program

    cfg = tiny("webgl_default_f32")
    c = program.fluid_config(cfg)
    sims = 4
    splats = traces(cfg, 7, sims, 21)
    warm = make_batched_multi_step(c, device="cpu")(
        program.Program.init(_stub(c, sims)), np.float32(1 / 60), splats[:6])
    if kind == "scalar":
        dt, table = np.float32(1 / 60), np.full((1, sims), 1 / 60, np.float32)
    else:
        table = np.zeros((4, sims), np.float32)
        table[:, :2] = 1 / 60
        table[0] = 1 / 60
        dt = table
    state, frames = make_tick_program(c, sims, kind)(warm, dt, splats[6])
    store = fluid.storage("float32")
    f = program.fields(warm)
    if kind == "scalar":
        f = fluid.step(f, table[0], torch.from_numpy(splats[6]), cfg, store, False)
    else:
        f = fluid.substep_tick(f, table, torch.from_numpy(splats[6]), cfg, store, False)
    for k, v in program.fields(state).items():
        assert torch.equal(v, f[k]), k
    ref = frame.frame(f["dye"], cfg, torch.from_numpy(bluenoise.tile()))
    assert frames.shape == ref.shape and frames.dtype == torch.uint8
    assert torch.equal(frames, ref)
    assert int(ref.max()) > 0


def _stub(c, sims):
    p = program.Program.__new__(program.Program)
    p.config, p.entry, p.sims, p.device = c, "tick", sims, torch.device("cpu")
    return p


def test_dither_tile_is_the_one_the_program_ships():
    from tpufluid_torch.utils.bluenoise import blue_noise_64

    t = bluenoise.tile()
    assert t.shape == (64, 64) and t.dtype == np.float32
    assert np.array_equal(t, blue_noise_64())
    assert np.array_equal(np.sort(t.ravel()), (np.arange(4096, dtype=np.float32) + 0.5) / 4096)


def test_rgb9e5_round_trip_keeps_nine_bits_of_the_largest_channel():
    x = torch.tensor([[[[1.0]], [[0.5]], [[0.0]]], [[[3.0e-3]], [[7.0]], [[-1.0]]]])
    y = fluid.rgb9e5(x)
    assert torch.equal(y[0, :, 0, 0], torch.tensor([1.0, 0.5, 0.0]))
    assert y[1, 2, 0, 0] == 0.0
    assert abs(float(y[1, 1, 0, 0]) - 7.0) <= 7.0 / 512
    assert float(y[1, 0, 0, 0]) == pytest.approx(0.0, abs=7.0 / 256)


def test_lower_storage_types_round():
    x = torch.tensor([1.0 + 2 ** -12, 1000.0, -1000.0])
    assert fluid.storage("float32")(x) is x
    assert fluid.storage("bfloat16")(x)[0] == 1.0
    e4m3 = fluid.storage("float8_e4m3fn")(x)
    assert torch.isfinite(e4m3).all() and e4m3[1] == 448.0 and e4m3[2] == -448.0
