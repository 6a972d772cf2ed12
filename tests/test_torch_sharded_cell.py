"""The sharded deployment's path on the CPU: the kernel wrappers' launch on
the card that holds their tensors (the device and stream lookups mocked),
the cell ``grid32768_bf16_2x2.sharded_steps`` at 256^2 on four CPU shards
through fluidbench's harness against its banded reference (correct; not
correct with the halo left out or a control in the program's place), the
banded control against the whole grid's, and the sharded step's spans: how
they nest, the launches and the halo bytes they count."""

import dataclasses
import io
import time

import pytest
import torch

from fluidbench import check, control, control_banded, harness, program
from fluidbench.reference import banded
from fluidbench.traffic.generator import generate
from tpufluid_torch import spans
from tpufluid_torch.ops.cuda import build, dispatch
from tpufluid_torch.parallel import halo, sharded_step

CELL = "grid32768_bf16_2x2.sharded_steps"
SEED = 2 ** 31 + 57
PASSES = ("pre_pressure", "projection", "velocity_advection", "dye_advection")
HALO = ("halo.rows", "halo.cols", "halo.mirror")


class OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card ``card`` (cuda:2 unless set)."""

    card = 2

    def get_device(self):
        return self.card


def on_card(index: int) -> torch.Tensor:
    t = torch.zeros(4).as_subclass(OnCard)
    t.card = index
    return t


@pytest.fixture
def cards(monkeypatch):
    """Mocked CUDA lookups: the current device (0 until a ``torch.cuda.device``
    block sets another), each device's current stream (handle 1000 + index),
    and the devices each such block entered."""
    now = {"device": 0, "entered": []}

    class Device:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            now["entered"].append(self.index)
            self.prev, now["device"] = now["device"], self.index

        def __exit__(self, *exc):
            now["device"] = self.prev
            return False

    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1000 + index,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: now["device"])
    monkeypatch.setattr(torch.cuda, "device", Device)
    return now


@pytest.fixture
def kernel(monkeypatch, cards):
    """A build.Kernel whose launch records the current device and its stream."""
    k = build.Kernel.__new__(build.Kernel)
    k.name, k.launches, k.seen = "sharded_cell_test", 0, []
    k._fn = lambda *a: k.seen.append((cards["device"], a[-1].value)) or 0
    monkeypatch.setitem(build.KERNELS, k.name, k)
    return k


def test_a_launch_goes_to_the_card_of_its_tensors(kernel, cards):
    """The current device is cuda:0, the tensors lie on cuda:2: the launch
    gets cuda:2's stream and runs with cuda:2 current, then cuda:0 again."""
    s = build.stream(on_card(2))
    assert (s.value, s.device) == (1002, 2)
    kernel(build.ptr(None), s)
    assert kernel.seen == [(2, 1002)] and cards["entered"] == [2] and cards["device"] == 0
    assert kernel.launches == 1


def test_a_launch_on_the_current_card_switches_nothing(kernel, cards):
    s = build.stream(on_card(0))
    assert (s.value, s.device) == (1000, None)
    kernel(s)
    assert kernel.seen == [(0, 1000)] and cards["entered"] == []
    cards["device"] = 3
    kernel(build.stream(on_card(3)))
    assert kernel.seen[-1] == (3, 1003) and cards["entered"] == []
    kernel(build.stream())                           # no tensor: the current card's
    assert kernel.seen[-1] == (3, 1003) and cards["entered"] == []


def small_cell(**cfg):
    """The cell at 256^2 on four CPU shards, every phase split (OVERLAP_HALO),
    one warm-up call."""
    cell = harness.load_cell(CELL)
    size = dict(SIM_RESOLUTION=256, DYE_RESOLUTION=256, CANVAS_WIDTH=256, CANVAS_HEIGHT=256,
                OVERLAP_HALO=True)
    return dataclasses.replace(cell, cfg=dict(cell.cfg, **size, **cfg),
                               mix=dict(cell.mix, warm_calls=1))


def run(cell, make_program=None):
    return harness.run(cell, SEED, 0.2, False, [torch.device("cpu")] * 4, time.perf_counter(),
                       make_program=make_program, log=io.StringIO())


@pytest.fixture
def overlap_count(monkeypatch):
    """How often the split-phase form ran."""
    n = [0]
    inner = sharded_step._overlap_rows

    def counted(*a, **k):
        n[0] += 1
        return inner(*a, **k)

    monkeypatch.setattr(sharded_step, "_overlap_rows", counted)
    return n


@pytest.mark.parametrize("budget", [None, 1], ids=["one_band", "a_band_a_step_unit"])
def test_the_cells_path_is_correct_against_the_banded_reference(monkeypatch, budget,
                                                                overlap_count):
    if budget is not None:
        monkeypatch.setattr(banded, "BUDGET_BYTES", budget)
    cell = small_cell()
    assert program.fluid_config(cell.cfg).dtype == torch.bfloat16
    assert check.precision(cell.cfg) == ("bfloat16", True) and cell.mix["chunk"] == 1
    r = run(cell)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    # a step splits each of its four phases and each Jacobi exchange
    assert overlap_count[0] >= 6 * (2 + r["attempted"])
    value, limit = r["checks"]["state_err"]["value"], r["checks"]["state_err"]["limit"]
    assert 0 < value <= limit


def zero_halo(monkeypatch):
    monkeypatch.setattr(halo, "_send", lambda x, device: torch.zeros_like(x, device=device))


@pytest.mark.parametrize("broken", ["halo_left_out", "control", "banded_control"])
def test_the_cells_path_broken_or_a_control_is_not_correct(monkeypatch, broken):
    make = {"control": control.Control, "banded_control": control_banded.BandedControl}
    if broken == "halo_left_out":
        zero_halo(monkeypatch)
    r = run(small_cell(), make.get(broken))
    assert r["correct"] is False
    assert r["checks"]["state_err"]["value"] > r["checks"]["state_err"]["limit"]


@pytest.mark.parametrize("mesh", [[2, 2], [4, 1]], ids=["2x2", "4x1"])
def test_the_banded_control_is_the_whole_grid_control_bit_for_bit(monkeypatch, mesh):
    """Two calls of the control in bands of 64 rows over the blocks of a
    mesh equal two of the whole grid's control."""
    cell = small_cell(MESH=mesh)
    monkeypatch.setattr(banded, "BUDGET_BYTES", (64 + 2 * banded.reach(cell.cfg)) * 256 * 256)
    traffic = generate(cell.mix, cell.cfg, SEED)
    devices = [torch.device("cpu")] * 4
    a = control_banded.BandedControl(cell.cfg, cell.mix, traffic, devices)
    b = control.Control(cell.cfg, cell.mix, traffic, devices)
    assert len(a.bands) == 4
    sa, sb = a.init(), b.init()
    for t in (0, 1):
        sa, _ = a.call(sa, t)
        sb, _ = b.call(sb, t)
    assert sa[0][0].dye.dtype == torch.bfloat16
    got = program.fields(sa)
    for k in ("velocity", "dye", "pressure"):
        assert float(sb[k].abs().max()) > 0
        assert torch.equal(got[k], sb[k]), k


@pytest.fixture
def counting(monkeypatch):
    """The routed passes with a launch counted a call, as the kernels count
    theirs on a card (the CPU runs their plain versions)."""
    k = build.Kernel.__new__(build.Kernel)
    k.name, k.launches = "sharded_span_test", 0
    monkeypatch.setitem(build.KERNELS, k.name, k)

    def counted(fn):
        def run(*a, **kw):
            k.launches += 1
            return fn(*a, **kw)
        return run

    p = dispatch.ROUTED
    monkeypatch.setattr(dispatch, "ROUTED", dispatch.Passes(
        counted(p.pre_pressure), counted(p.jacobi_pressure), counted(p.gradient_subtract),
        counted(p.jacobi_project), counted(p.advect)))
    return k


def test_the_sharded_spans_nest_and_count_launches_and_halo_bytes(counting):
    cell = small_cell()
    traffic = generate(cell.mix, cell.cfg, SEED)
    prog = program.Program(cell.cfg, cell.mix, traffic, [torch.device("cpu")] * 4)
    state, _ = prog.call(prog.init(), 0)
    spans.enable(4096)
    try:
        sent, launched = halo.SENT.bytes, counting.launches
        prog.call(state, 1)
        sent, launched = halo.SENT.bytes - sent, counting.launches - launched
        got = spans.take()
    finally:
        spans.disable()
    by_id = {s.id: s for s in got}
    roots = [s for s in got if s.parent == 0]
    assert [s.name for s in roots] == ["multi_step"]
    assert all(s.root == roots[0].id for s in got)
    parent = {s.name: by_id[s.parent].name for s in got if s.parent}
    assert parent["upload"] == parent["step"] == "multi_step"
    assert {n: parent[n] for n in ("splat_factors",) + PASSES} == dict.fromkeys(
        ("splat_factors",) + PASSES, "step")
    for s in got:
        if s.name in HALO:
            assert by_id[s.parent].name in PASSES, s
    # the call's launches, all in the passes' spans
    assert launched > 0 and sum(s.launches for s in got) == launched
    assert sum(s.launches for s in got if s.name in PASSES) == launched
    # the halo's bytes, all in the halo.* spans, each kind of exchange sending some
    assert sent > 0 and sum(s.bytes for s in got) == sent
    for name in HALO:
        assert sum(s.bytes for s in got if s.name == name) > 0, name
    assert sum(s.bytes for s in got if s.name in HALO) == sent


def test_span_window_puts_each_device_event_down_to_its_launchs_span():
    """Fake profiler events: two nested ranges, a kernel launched in each,
    a copy between cards in the inner one, a kernel with no launch call,
    and the profiler's own device rows of the ranges (left out)."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from tpufluid_torch.tools.span_window import by_span

    def ev(name, start, dur, device=False, id=0):
        return SimpleNamespace(name=name, id=id,
                               device_type=DeviceType.CUDA if device else DeviceType.CPU,
                               time_range=SimpleNamespace(start=start,
                                                          elapsed_us=lambda d=dur: d))

    events = [ev("step", 0, 100), ev("halo.cols", 10, 20),
              ev("cudaLaunchKernel", 5, 1, id=1), ev("cudaLaunchKernel", 12, 1, id=2),
              ev("cudaMemcpyAsync", 15, 1, id=3),
              ev("void advect_kernel<float>(...)", 30, 7, True, 1),
              ev("at::native::CatArrayBatchedCopy", 40, 5, True, 2),
              ev("Memcpy PtoP (Device -> Device)", 50, 2, True, 3),
              ev("void jacobi_chunk_kernel<float>(...)", 60, 3, True, 9),
              ev("halo.cols", 12, 40, True)]
    got = by_span(events, {"step", "halo.cols"})
    assert got["step"] == {"device_us": 7.0, "kernels": 1, "copies": 0, "copy_us": 0.0}
    assert got["halo.cols"] == {"device_us": 7.0, "kernels": 1, "copies": 1, "copy_us": 2.0}
    assert got["outside"] == {"device_us": 3.0, "kernels": 1, "copies": 0, "copy_us": 0.0}
