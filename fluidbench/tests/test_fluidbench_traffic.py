"""The traffic generator: the program's own pointer traces at one seed,
and the mixes' arrivals."""

import json
from pathlib import Path

import numpy as np
import pytest

from fluidbench import program
from fluidbench.traffic.generator import generate, load

HERE = Path(__file__).resolve().parents[1]
MIXES = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 9])
def test_one_swirl_is_the_programs_swirl_trace(seed):
    from tpufluid_torch.trace import swirl_trace

    cfg = config("webgl_default_f32")
    mix = {"entry": "multi_step", "sims": 1, "chunk": 10, "length": 240, "dt": 1 / 60,
           "pointer": {"period": [120, 120], "amp": [0.3, 0.3], "phase": "zero"},
           "burst": {"every": 10 ** 6, "first": 0, "size": [8, 8]}}
    tr = generate(mix, cfg, seed)
    ref = swirl_trace(program.fluid_config(cfg), 240, seed=seed)
    assert np.array_equal(tr.splats[:, 0], ref.batches)
    assert np.array_equal(np.minimum(tr.dts[:, 0], np.float32(0.016666)), ref.dts)


@pytest.mark.parametrize("name", MIXES)
def test_mixes_are_whole_and_repeat_from_the_seed(name):
    mix = load(name)
    cfg = config("grid4096_bf16" if name == "steps" else "webgl_default_f32")
    assert mix["length"] % mix.get("chunk", 1) == 0
    a, b = generate(mix, cfg, 2 ** 31 + 3), generate(mix, cfg, 2 ** 31 + 3)
    assert np.array_equal(a.splats, b.splats) and np.array_equal(a.dts, b.dts)
    c = generate(mix, cfg, 2 ** 31 + 4)
    assert not np.array_equal(a.splats, c.splats)
    active = a.splats[..., 7] != 0
    # Every sim's pointer splats every step; a burst fills at most the rows
    # left beside it.
    assert active.sum(axis=-1).min() >= 1
    assert active.sum(axis=-1).max() <= cfg["MAX_SPLATS"]
    # The same set of dts and pointer periods for every seed, in another order.
    assert np.array_equal(np.sort(a.dts[0]), np.sort(c.dts[0]))
    assert a.substeps.tolist() == mix.get("speeds", [1] * mix["sims"])
