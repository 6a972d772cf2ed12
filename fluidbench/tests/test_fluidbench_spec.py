"""BENCHMARK.json against the benchmark's contract, and every file a cell
is found by."""

import json
import re
from pathlib import Path

import pytest

from fluidbench import harness, work

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_and_sizes():
    assert set(BENCH) == KEYS
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["fluidbench"]
    assert BENCH["command"][:2] == ["python3", "-m"] and len(BENCH["command"]) <= 32
    # A full check of 24 cells fits its 43,200 seconds.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound", "source"}),
                        ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == keys, e
            assert NAME.match(e["name"]) and e["name"] not in seen, e["name"]
            seen.add(e["name"])
            for k in ("why", "layer", "source"):
                if k in e and group != "end_to_end" and group != "per_layer":
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200


def test_every_cell_has_its_files_and_metrics():
    names = {w["name"] for w in BENCH["workloads"]}
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(names) // 4)
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("fluidbench/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
            reader = m["name"].split(".")[0]
            assert (ROOT / "fluidbench" / "metrics" / f"{reader}.py").is_file()
            assert m["name"].split(".")[-1] == cell.unit
            if reader == "roofline_pct":
                assert m["name"].split(".")[1] in work.passes()
        assert set(cell.limits) == ({"state_err", "frame_mismatch_pct"} if cell.unit == "tick"
                                    else {"state_err"})
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        assert set(m.get("workloads", [])) <= names


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files_state_their_source(c):
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["reduced"] == c["reduced"] == []
    assert cfg["source"] and "assumed" in cfg
