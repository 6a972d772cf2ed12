"""The program's spans beside the device trace (fluidbench/programspans.py)
on a made-up timeline: the clock's alignment, the innermost span, the
attribution of launches, device time and idle to spans (which must add up
to the trace's own), the breakdown by span, the span readers and their
None; then each cell at a rehearsal's size with the program's recorder."""

import io
import json
from pathlib import Path

import pytest

from fluidbench import devtrace, harness, metrics, programspans, rehearse
from fluidbench.devtrace import Event
from fluidbench.programspans import OUTSIDE_SPAN, Traced, Timeline
from tpufluid_torch.spans import Span

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
OFF = 5_000.0          # µs: the profiler's clock minus the host's


def made_up():
    """Two ticks 100 µs apart. Each: tick [10, 60] holding step [10, 30]
    (splat_factors [12, 20] inside) and frame [30, 55] (sunrays [32, 50]
    inside). Launches at 13, 15 (splat factors), 22 (pre_pressure, the
    program's), 33, 40 (sunrays), 52 (display, the program's), 57 (a copy);
    each runs 5 µs after its launch for 1 µs. The markers run at 0 and 300
    on the device, launched at -5 and 295."""
    spans, device, launch, host = [], [], {}, []
    sid = 0
    for k in range(2):
        t0 = 100.0 * k

        def sp(name, a, b, parent, root, launches=0):
            nonlocal sid
            sid += 1
            spans.append(Span(sid, parent, root, 1, name, int((t0 + a - OFF) * 1e3),
                              int((t0 + b - OFF) * 1e3), launches))
            return sid

        tick = sid + 1
        sp("tick", 10, 60, 0, tick)
        step = sp("step", 10, 30, tick, tick, 1)
        sp("splat_factors", 12, 20, step, tick)
        frame = sp("frame", 30, 55, tick, tick, 1)
        sp("sunrays", 32, 50, frame, tick)
        for at, name in ((13, "at::native::elementwise_kernel"), (15, "at::native::reduce_kernel"),
                         (22, "pre_pressure_kernel"), (33, "at::native::elementwise_kernel"),
                         (40, "at::native::_scatter_gather_elementwise_kernel"),
                         (52, "display_kernel"), (57, "Memcpy HtoD (Pageable -> Device)")):
            e = Event(name, True, t0 + at + 5.0, 1.0)
            device.append(e)
            launch[e.start] = t0 + at
            host.append(Event("cudaLaunchKernel", False, t0 + at, 0.5))
        host.append(Event("cudaStreamSynchronize", False, t0 + 60.0, 40.0))
    events = [Event("spin_kernel", True, 0.0, 1.0), Event("spin_kernel", True, 300.0, 1.0)]
    events += device + host
    # Each marker's launch (1 µs long) ran between two host stamps 4 µs
    # apart.
    brackets = [[(int((-7 - OFF) * 1e3), int((-3 - OFF) * 1e3), -5.0, -4.0)],
                [(int((293 - OFF) * 1e3), int((297 - OFF) * 1e3), 295.0, 296.0)]]
    d = devtrace.digest(events, 2, "tick")
    return d, Traced(events, launch, brackets, (-5.0, 295.0)), spans


def port(name):
    return name in ("pre_pressure_kernel", "display_kernel")


def test_the_clock_and_its_error():
    # A call of 1 µs between stamps 4 µs apart: the offset lies in a range
    # 3 µs wide; two calls at one end narrow it to where both allow.
    one = [(0, 4000, 11.0, 12.0)]
    c = programspans.Clock([one, [(100_000, 104_000, 111.0, 112.0)]])
    assert c(0) == pytest.approx(9.5) and c.err_us == pytest.approx(1.5) and c.drift_us == 0.0
    end = [(100_000, 104_000, 111.0, 112.0)]
    c = programspans.Clock([one + [(50_000, 52_000, 60.5, 61.5)], end])
    assert c.off[0] == pytest.approx(10.0) and c.err_us == pytest.approx(1.5)
    # The two ends disagree by 4 µs: the clock draws a line between them.
    c = programspans.Clock([one, [(100_000, 104_000, 115.0, 116.0)]])
    assert c.drift_us == pytest.approx(4.0)
    assert c(0) == pytest.approx(9.5) and c(100_000) == pytest.approx(113.5)
    assert c(50_000) == pytest.approx(50.0 + 11.5)
    _, traced, spans = made_up()
    c = programspans.Clock(traced.brackets)
    assert c(0) == pytest.approx(OFF + 0.5) and c.err_us == pytest.approx(1.5)
    on = programspans.on_clock(spans, lambda ns: ns * 1e-3 + OFF)
    assert (on[0].name, on[0].start, on[0].end) == ("tick", 10.0, 60.0)


def test_the_timeline_names_the_innermost_span():
    _, traced, spans = made_up()
    line = Timeline(programspans.on_clock(spans, lambda ns: ns * 1e-3 + OFF))
    for t, name in ((5, OUTSIDE_SPAN), (11, "step"), (13, "splat_factors"), (20.5, "step"),
                    (31, "frame"), (40, "sunrays"), (52, "frame"), (57, "tick"),
                    (80, OUTSIDE_SPAN), (140, "sunrays"), (500, OUTSIDE_SPAN)):
        assert line.at(t) == name, t


def test_attribution_adds_up_to_the_trace():
    d, traced, spans = made_up()
    line = Timeline(programspans.on_clock(spans, lambda ns: ns * 1e-3 + OFF))
    att = programspans.attribute(d, line, traced.launch, port)
    assert {k: v["launches"] for k, v in att.items()} == \
        {"splat_factors": 4, "step": 2, "sunrays": 4, "frame": 2, "tick": 0, OUTSIDE_SPAN: 0}
    assert sum(v["launches"] for v in att.values()) == len(d.kernels()) == 12
    assert att["tick"]["device_us"] == pytest.approx(2.0)           # the copies
    assert sum(v["device_us"] for v in att.values()) == pytest.approx(sum(e.dur for e in d.device))
    assert sum(v["idle_us"] for v in att.values()) == pytest.approx(d.window_us - d.busy_us())
    # Outside every span, by their middles: the window's start to the first
    # kernel (1-18), each tick's gap that ends at its copy (58-62, middle
    # 60, where the tick ends), the gap between the ticks (63-118) and the
    # last copy to the marker (163-300).
    assert att[OUTSIDE_SPAN]["idle_us"] == pytest.approx(17.0 + 4.0 + 55.0 + 4.0 + 137.0)
    assert att["sunrays"]["idle_us"] == pytest.approx(2 * (10.0 + 6.0))
    own = programspans.counted(programspans.on_clock(spans, lambda ns: ns * 1e-3 + OFF), -5, 295)
    assert own == {"tick": 0, "step": 2, "splat_factors": 0, "frame": 2, "sunrays": 0}
    assert {k: att[k]["port"] for k in own} == own


def test_context_and_the_readers():
    d, traced, spans = made_up()
    ps = programspans.context(d, traced, spans, spans, 2, port)
    closes = ps["closes"]
    assert closes["launches"] == [12, 12]
    assert closes["device_us"][0] == pytest.approx(closes["device_us"][1])
    assert closes["idle_us"][0] == pytest.approx(closes["idle_us"][1])
    assert all(a == b for a, b in closes["port"].values())
    ctx = {"digest": d, "program_spans": ps}
    assert metrics.read("span_launches.sunrays.tick", ctx) == 2.0
    assert metrics.read("span_launches.tick.tick", ctx) == 0.0      # opened, launched nothing
    assert metrics.read("span_host_ms.tick.tick", ctx) == pytest.approx(0.050)
    assert metrics.read("span_host_ms.sunrays.tick", ctx) == pytest.approx(0.018)
    assert metrics.read("span_device_ms.sunrays.tick", ctx) == pytest.approx(0.002)
    assert metrics.read("span_idle_ms.outside.tick", ctx) == \
        pytest.approx(ps["idle_ms"][OUTSIDE_SPAN])
    assert metrics.read("span_host_ms.outside.tick", ctx) is None
    assert metrics.read("span_device_ms.select.tick", ctx) is None   # never opened
    assert metrics.read("span_launches.sunrays.step", ctx) is None    # not the cell's unit
    for q in ("span_host_ms", "span_launches", "span_device_ms", "span_idle_ms"):
        assert metrics.read(f"{q}.sunrays.tick", {"digest": d}) is None   # no program spans


def test_the_breakdown_names_idle_by_span_and_is_unchanged_without():
    d, traced, spans = made_up()
    assert programspans.breakdown(d, None) == devtrace.breakdown(d)
    line = Timeline(programspans.on_clock(spans, lambda ns: ns * 1e-3 + OFF))
    b = programspans.breakdown(d, line)
    assert b["device_ops"] == devtrace.breakdown(d)["device_ops"]
    gaps = dict(b["idle_gaps"])
    assert "cudaStreamSynchronize" in gaps                     # outside every span
    assert any(k.startswith("sunrays / ") for k in gaps)
    assert sum(gaps.values()) == pytest.approx((d.window_us - d.busy_us()) * 1e-6)


def test_launches_are_tied_by_correlation_id_then_by_order():
    class E:
        def __init__(self, name, dev, start, cid):
            self.name, self.device_type, self.id = name, dev, cid
            self.time_range = type("R", (), {"start": start, "elapsed_us": lambda s: 1.0})()

    evs = [E("cudaLaunchKernel", 0, 1.0, 7), E("cudaLaunchKernel", 0, 2.0, 8),
           E("cudaMemcpyAsync", 0, 3.0, 0), E("k", 1, 10.0, 8), E("k", 1, 11.0, 7),
           E("Memcpy HtoD", 1, 12.0, 99)]
    events, launch, unmatched = programspans._launches(evs, 1)
    assert {k: v.start for k, v in launch.items()} == {10.0: 2.0, 11.0: 1.0, 12.0: 3.0}
    assert unmatched == 0
    assert [e.device for e in events] == [False] * 3 + [True] * 3


def test_the_span_metrics_are_entries_of_the_benchmark_s_form():
    cells = {w["name"] for w in BENCH["workloads"]}
    layers = {m["layer"] for m in BENCH["per_layer"]}
    moves = {m["name"]: m for m in BENCH["end_to_end"]}
    entries = programspans.per_layer()
    assert len(entries) == 11 and len({m["name"] for m in entries}) == 11
    for m in entries:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["layer"] in layers and set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(moves[m["moves"]]["workloads"])
        assert m["name"].split(".")[0] in ("span_host_ms", "span_launches", "span_device_ms",
                                           "span_idle_ms")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_a_rehearsal_reads_the_span_metrics_and_closes(name):
    import dataclasses

    import torch
    from tpufluid_torch import spans

    cell = harness.load_cell(name)
    cell = dataclasses.replace(cell, cfg=rehearse.shrink(cell.cfg),
                               mix=rehearse.shrink_mix(cell.mix))
    r = programspans.run(cell, 2 ** 31 + 7, 0.2, torch.device("cpu"), spans, log=io.StringIO())
    want = {m["name"] for m in programspans.per_layer() if name in m["workloads"]}
    assert want <= set(r["metrics"]) and r["closes"] is True
    assert r["unmatched"] == 0 and spans.recorder() is None
    json.dumps(r)
