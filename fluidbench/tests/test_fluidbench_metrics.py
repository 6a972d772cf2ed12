"""The per-layer readers on a made-up device timeline: their arithmetic,
and that a reader with nothing to read gives nothing."""

import json
from pathlib import Path

import pytest

from fluidbench import devtrace, metrics, work
from fluidbench.devtrace import Event

HERE = Path(__file__).resolve().parents[1]


def timeline():
    """Two ticks: markers, each tick a pre_pressure, a jacobi pair, an
    advect pair, a PyTorch kernel, a copy to the host, host gaps between."""
    ev = [Event("spin_kernel", True, 0.0, 1.0)]
    t = 10.0
    for _ in range(2):
        for name, dur in (("void pre_pressure_kernel<float, 8, 32, false>(float const*)", 5.0),
                          ("void jacobi_chunk_kernel<float>(...)", 10.0),
                          ("void jacobi_project_kernel<float>(...)", 10.0),
                          ("void advect_kernel<float>(...)", 5.0),
                          ("void advect_dye_kernel<float, 3>(...)", 20.0),
                          ("void bloom_pyramid_kernel(Pyramid)", 8.0),
                          ("void display_kernel<float, 3, false>(...)", 12.0),
                          ("void at::native::elementwise_kernel<128, 4>(...)", 10.0),
                          ("Memcpy DtoH (Device -> Pageable)", 20.0)):
            ev.append(Event(name, True, t, dur))
            t += dur
        ev.append(Event("cudaStreamSynchronize", False, t, 20.0))
        t += 20.0
    ev.append(Event("spin_kernel", True, t, 1.0))
    ev.append(Event("aten::add", False, 12.0, 3.0))
    return devtrace.digest(ev, 2, "tick"), t - 1.0


def context(d):
    cfg = json.loads((HERE / "configs" / "webgl_default_f32.json").read_text())
    return {"digest": d, "shape": work.Shape(cfg, 16, 4, 1, 2.0, 1),
            "peaks": {"bytes_per_s": 3.35e12, "flops_per_s": 67e12},
            "spans": {"host_s": 0.004, "units": 2, "window_s": 500e-6}}


def test_window_busy_and_idle():
    d, window = timeline()
    assert d.window_us == pytest.approx(window)
    assert d.busy_us() == pytest.approx(2 * 100.0)
    # Against the measured window's 250 us a tick, not the traced window's.
    assert metrics.read("idle_pct.tick", context(d)) == pytest.approx(100 * (1 - 100.0 / 250.0))
    gaps = d.gaps()
    assert sum(b - a for a, b in gaps) == pytest.approx(window - 200.0)


def test_counts_times_and_rooflines():
    d, _ = timeline()
    ctx = context(d)
    assert metrics.read("launches.tick", ctx) == 8
    assert metrics.read("torch_ops_ms.tick", ctx) == pytest.approx(0.010)
    assert metrics.read("host_ms.tick", ctx) == pytest.approx(2.0)
    nbytes, ops = work.pass_work("display", ctx["shape"])
    bound = max(nbytes / 3.35e12, ops / 67e12)
    assert metrics.read("roofline_pct.display.tick", ctx) == pytest.approx(100 * bound / 12e-6)
    nbytes, ops = work.pass_work("projection", ctx["shape"])
    bound = max(nbytes / 3.35e12, ops / 67e12)
    assert metrics.read("roofline_pct.projection.tick", ctx) == pytest.approx(100 * bound / 20e-6)
    bounds = sum(max(b / 3.35e12, f / 67e12)
                 for b, f in (work.pass_work(p, ctx["shape"]) for p in work.passes()))
    assert metrics.read("mfu_roofline.tick", ctx) == pytest.approx(100 * bounds / 250e-6)


def test_a_reader_with_nothing_to_read_gives_nothing():
    d, _ = timeline()
    ctx = context(d)
    assert metrics.read("roofline_pct.display.step", ctx) is None     # not the cell's unit
    empty = devtrace.digest([Event("spin_kernel", True, 0.0, 1.0),
                             Event("spin_kernel", True, 50.0, 1.0)], 1, "tick")
    ctx = context(empty)
    for name in ("roofline_pct.display.tick", "torch_ops_ms.tick", "launches.tick"):
        assert metrics.read(name, ctx) is None
    assert metrics.read("idle_pct.tick", ctx) == pytest.approx(100.0)
    ctx["spans"] = {"host_s": 0.0, "units": 0, "window_s": 0.0}
    assert metrics.read("idle_pct.tick", ctx) is None
    assert metrics.read("mfu_roofline.tick", ctx) is None


def test_breakdown_names_device_ops_and_what_the_host_did_while_idle():
    d, _ = timeline()
    b = devtrace.breakdown(d)
    assert b["device_ops"][0][0] in ("advect_dye_kernel", "Memcpy DtoH (Device -> Pageable)")
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert dict(b["idle_gaps"])["cudaStreamSynchronize"] == pytest.approx(40e-6)


def test_a_window_without_its_markers_is_refused():
    with pytest.raises(RuntimeError):
        devtrace.digest([Event("spin_kernel", True, 0.0, 1.0)], 1, "step")


def test_kernel_names_reduce_to_their_stems():
    assert devtrace.stem("void advect_dye_kernel<float, 3>(float const*, int)") == "advect_dye_kernel"
    assert devtrace.stem("void at::native::(anonymous namespace)::fill_kernel<float>(float)") == \
        "at::native::fill_kernel"
    assert devtrace.stem("void (anonymous namespace)::spin(long)") == "spin"
