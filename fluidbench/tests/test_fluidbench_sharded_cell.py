"""The sharded deployment's cell, ``grid32768_bf16_2x2.sharded_steps``, as
the harness loads it: its four cards, its mesh and the split-phase halo at
its size, one step a call, its metrics, and its configuration beside the
4096^2 one it scales."""

import json
from pathlib import Path

from fluidbench import harness, program
from fluidbench.reference import banded

CELL = "grid32768_bf16_2x2.sharded_steps"
CONFIGS = Path(__file__).resolve().parents[1] / "configs"
STEP_METRICS = {"host_ms.step", "torch_ops_ms.step", "launches.step",
                "roofline_pct.projection.step", "roofline_pct.dye_advection.step",
                "idle_pct.step", "mfu_roofline.step"}


def test_the_cell_loads_on_four_cards_with_its_mesh_one_step_a_call():
    cell = harness.load_cell(CELL)
    assert cell.workload["chips"] == 4 and cell.mix["entry"] == "sharded_multi_step"
    assert cell.mix["chunk"] == 1 and cell.mix["sims"] == 1
    ny, nx = cell.cfg["MESH"]
    assert ny * nx == cell.workload["chips"] == 4
    config = program.fluid_config(cell.cfg)
    (sw, sh), (dw, dh) = config.sim_size, config.dye_size
    assert (sw, sh, dw, dh) == (32768,) * 4
    assert sh % ny == dh % ny == sw % nx == dw % nx == 0
    # a 16384-row block is past the crossover: the split-phase halo
    assert config.OVERLAP_HALO is None and sh // ny >= config.OVERLAP_CROSSOVER
    assert config.overlap_halo is True
    assert {m["name"] for m in cell.per_layer} == STEP_METRICS | {"copy_ms.step"}
    assert {m["name"] for m in cell.end_to_end} == {"sim_steps_per_s", "setup_s"}
    assert set(cell.limits) == {"state_err"}


def test_the_configuration_is_the_4096_one_at_32768_on_a_2x2_mesh():
    big = json.loads((CONFIGS / "grid32768_bf16_2x2.json").read_text())
    small = json.loads((CONFIGS / "grid4096_bf16.json").read_text())
    changed = {k for k in set(big) | set(small) if big.get(k) != small.get(k)}
    assert changed == {"SIM_RESOLUTION", "DYE_RESOLUTION", "CANVAS_WIDTH", "CANVAS_HEIGHT",
                       "MESH", "source", "assumed", "deployment"}
    assert big["MESH"] == [2, 2] and big["OVERLAP_HALO"] is None and big["reduced"] == []


def test_the_banded_reference_of_a_step_fits_its_budget_at_full_size():
    cell = harness.load_cell(CELL)
    bands = banded.plan(cell.cfg, cell.mix["chunk"])
    margin = bands[1].keep[0] - bands[1].run[0]
    assert margin == banded.reach(cell.cfg) == 60
    run = bands[1].run[1] - bands[1].run[0]
    assert run * banded.BYTES_PER_TEXEL * 32768 <= banded.BUDGET_BYTES
    assert bands[-1].keep[1] == 32768 and len(bands) <= 16
