"""The port's span recorder (tpufluid_torch.spans) on the CPU: nesting,
parents, one root a call, one stack a thread, the buffer's capacity and
its dropped count, the ring, the launches a span counts; with the recorder
off nothing is recorded, nothing allocated and no clock read; and the step,
the fleet's ticks and the frame come out bit-equal with it on, with a span
at each pass."""

import threading

import numpy as np
import pytest
import torch

from tpufluid_torch import FluidConfig, fluid_step, init_state, make_multi_step, render_frame, spans
from tpufluid_torch.ops.cuda import build
from tpufluid_torch.serve_batch import make_tick_program
from tpufluid_torch.state import FluidState
from tpufluid_torch.trace import swirl_trace

CFG = FluidConfig(SIM_RESOLUTION=16, DYE_RESOLUTION=32, CANVAS_WIDTH=48, CANVAS_HEIGHT=32,
                  BLOOM_RESOLUTION=32, SUNRAYS_RESOLUTION=16, MAX_SPLATS=4).validate()
STEP_PASSES = ["upload", "splat_factors", "pre_pressure", "projection", "velocity_advection",
               "dye_advection"]
FRAME_PASSES = ["dye_cast", "bloom_resample", "bloom_pyramid", "sunrays", "display", "backdrop",
                "blend"]


@pytest.fixture
def recorder():
    rec = spans.enable(capacity=4096)
    try:
        yield rec
    finally:
        spans.disable()


@pytest.fixture
def kernel(monkeypatch):
    """A build.Kernel whose launch does nothing but count."""
    k = build.Kernel.__new__(build.Kernel)
    k.name, k.launches, k._fn = "span_test", 0, lambda *a: 0
    monkeypatch.setitem(build.KERNELS, k.name, k)
    return k


def by_name(got):
    return {s.name: s for s in got}


def test_spans_nest_with_their_parent_and_one_root_a_call(recorder):
    with spans.span("a"):
        with spans.span("b"):
            pass
        with spans.span("c"):
            with spans.span("d"):
                pass
    with spans.span("e"):
        pass
    got = spans.take()
    assert [s.name for s in got] == ["b", "d", "c", "a", "e"]     # kept as they end
    s = by_name(got)
    assert s["a"].parent == 0 and s["e"].parent == 0
    assert s["b"].parent == s["a"].id and s["c"].parent == s["a"].id
    assert s["d"].parent == s["c"].id
    assert {s[n].root for n in "abcd"} == {s["a"].id} and s["e"].root == s["e"].id
    assert len({x.id for x in got}) == 5
    for x in got:
        assert x.start_ns <= x.end_ns and x.thread == threading.get_ident()
    assert s["a"].start_ns <= s["b"].start_ns <= s["b"].end_ns <= s["c"].start_ns
    assert s["d"].end_ns <= s["c"].end_ns <= s["a"].end_ns <= s["e"].start_ns


def test_each_thread_has_its_own_stack(recorder):
    """Two threads open their spans interleaved: each span's parent is the
    open span of its own thread."""
    gate = threading.Barrier(2, timeout=10)

    def work(tag):
        with spans.span(f"outer{tag}"):
            gate.wait()
            with spans.span(f"inner{tag}"):
                gate.wait()
            gate.wait()

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    s = by_name(spans.take())
    for k in range(2):
        outer, inner = s[f"outer{k}"], s[f"inner{k}"]
        assert inner.parent == outer.id and inner.root == outer.id and outer.parent == 0
        assert inner.thread == outer.thread
    assert s["outer0"].thread != s["outer1"].thread


def test_a_full_buffer_drops_the_newest_and_counts_them():
    spans.enable(capacity=3)
    try:
        for k in range(5):
            with spans.span(f"s{k}"):
                pass
        assert [s.name for s in spans.take()] == ["s0", "s1", "s2"]
        assert spans.dropped() == 2
        assert spans.take() == []                   # take empties the buffer
        with spans.span("s5"):
            pass
        assert [s.name for s in spans.take()] == ["s5"] and spans.dropped() == 2
    finally:
        spans.disable()
    with pytest.raises(ValueError):
        spans.enable(capacity=0)


def test_a_ring_keeps_the_newest():
    rec = spans.enable(capacity=3, ring=True)
    try:
        for k in range(7):
            with spans.span(f"s{k}"):
                pass
        assert [s.name for s in rec.snapshot()] == ["s4", "s5", "s6"]
        assert [s.name for s in spans.take()] == ["s4", "s5", "s6"] and spans.dropped() == 0
        assert rec.snapshot() == []
    finally:
        spans.disable()


def test_a_span_counts_the_launches_inside_it_and_not_in_a_child(recorder, kernel):
    with spans.span("a"):
        kernel()
        with spans.span("b"):
            kernel()
            kernel()
        kernel()
        with spans.span("c"):
            pass
    kernel()                                        # outside every span
    s = by_name(spans.take())
    assert (s["a"].launches, s["b"].launches, s["c"].launches) == (2, 2, 0)
    assert kernel.launches == 5


def test_the_recorder_off_records_nothing_allocates_nothing_reads_no_clock(monkeypatch):
    """Off, span() hands out one shared object, and neither a span's record
    nor its open state is made, nor the clock or the launches read."""
    spans.disable()
    assert spans.span("x") is spans.span("y")
    assert type(spans.span("x")).__slots__ == ()

    def no(*a, **k):
        raise AssertionError("made or read while the recorder is off")

    for name in ("perf_counter_ns", "launches", "Span", "_Open"):
        monkeypatch.setattr(spans, name, no)
    for _ in range(1000):
        with spans.span("step"):
            with spans.span("pre_pressure"):
                pass
    assert spans.take() == [] and spans.dropped() == 0 and spans.recorder() is None


def test_summary_counts_and_percentiles():
    got = [spans.Span(k + 1, 0, k + 1, 0, "a" if k < 20 else "b", 0, (k + 1) * 1_000_000, 0)
           for k in range(21)]
    s = spans.summary(got)
    assert s["a"] == {"count": 20, "p50_ms": 10.0, "p95_ms": 19.0}
    assert s["b"] == {"count": 1, "p50_ms": 21.0, "p95_ms": 21.0}


def _splats(lead, seed):
    rng = np.random.default_rng(seed)
    s = np.zeros(lead + (CFG.MAX_SPLATS, 8), np.float32)
    s[..., :2] = rng.random(lead + (CFG.MAX_SPLATS, 2))
    s[..., 2:4] = rng.normal(0, 300, lead + (CFG.MAX_SPLATS, 2))
    s[..., 4:7] = rng.random(lead + (CFG.MAX_SPLATS, 3))
    s[..., 7] = 1.0
    return s


def _state(batch=None):
    sw, sh = CFG.sim_size
    dw, dh = CFG.dye_size
    lead = () if batch is None else (batch,)
    g = torch.Generator().manual_seed(3)
    mk = lambda *shape: torch.rand(lead + shape, generator=g) - 0.5  # noqa: E731
    return FluidState(velocity=mk(2, sh, sw) * 40, dye=mk(3, dh, dw) + 0.5, pressure=mk(sh, sw))


def _calls():
    """(name, call) of each entry the recorder must leave bit-equal."""
    k = 4
    dts = np.where(np.arange(k)[:, None] < np.array([1, 4, 2])[None, :], 1 / 60, 0.0)
    return {
        "fluid_step": lambda: fluid_step(_state(), 1 / 60, _splats((), 1), CFG),
        "tick_scalar": lambda: make_tick_program(CFG, 3, "scalar")(
            _state(3), np.float32(1 / 60), _splats((3,), 2)),
        "tick_k4": lambda: make_tick_program(CFG, 3, k)(
            _state(3), dts.astype(np.float32), _splats((3,), 3)),
        "render_frame": lambda: render_frame(_state(), CFG),
    }


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple) and not hasattr(x, "velocity"):
        return [t for y in x for t in _flat(y)]
    return [x.velocity, x.dye, x.pressure]


EXPECT = {
    "fluid_step": {"step"} | set(STEP_PASSES),
    "tick_scalar": {"tick", "step", "frame", "quantize"} | set(STEP_PASSES) | set(FRAME_PASSES),
    "tick_k4": {"tick", "step", "select", "frame", "quantize"} | set(STEP_PASSES)
    | set(FRAME_PASSES),
    "render_frame": {"frame"} | set(FRAME_PASSES),
}


@pytest.mark.parametrize("entry", sorted(EXPECT))
def test_results_are_bit_equal_with_the_recorder_on(entry):
    call = _calls()[entry]
    off = _flat(call())
    spans.enable()
    try:
        on = _flat(call())
        got = spans.take()
    finally:
        spans.disable()
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert {s.name for s in got} == EXPECT[entry]
    roots = [s for s in got if s.parent == 0]
    assert len(roots) == 1 and all(s.root == roots[0].id for s in got)
    assert all(s.launches == 0 for s in got)         # the CPU runs the plain versions
    if entry == "tick_k4":
        assert sum(s.name == "step" for s in got) == 4 and sum(s.name == "select" for s in got) == 3


def test_a_chunk_spans_its_upload_and_each_steps_passes():
    trace = swirl_trace(CFG, 3, seed=4)
    multi = make_multi_step(CFG, device="cpu")
    spans.enable()
    try:
        multi(init_state(CFG, device="cpu"), trace.dts, trace.batches)
        got = spans.take()
    finally:
        spans.disable()
    root = got[-1]
    assert root.name == "multi_step" and root.parent == 0
    kids = [s for s in got if s.parent == root.id]
    assert [s.name for s in kids] == ["upload", "step", "step", "step"]
    for step in kids[1:]:
        assert [s.name for s in got if s.parent == step.id] == STEP_PASSES
        assert step.start_ns <= min(s.start_ns for s in got if s.parent == step.id)
