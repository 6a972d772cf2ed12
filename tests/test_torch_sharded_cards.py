"""The sharded step across four cards: every shard's kernels launch on the
card that holds the shard.

These tests need four NVIDIA GPUs with nvcc (sm_90a); with fewer every test
skips with its reason. They import no JAX, so on a machine with four cards
run
    python -m pytest --noconftest tests/test_torch_sharded_cards.py -q
The same sharded step, on the same data, with the shards of a 2x2 mesh on
cuda:0-3 and with all four on cuda:0, runs the same kernels on the same
blocks: any difference is a launch on the wrong card or a copy between
cards that raced its use.
"""

import pytest
import torch

from tpufluid_torch import FluidConfig, init_state, shard_state, swirl_trace
from tpufluid_torch.ops.cuda import build
from tpufluid_torch.parallel import make_sharded_multi_step
from tpufluid_torch.parallel.mesh import gather_state, make_mesh
from tpufluid_torch.state import FluidState

FIELDS = ("velocity", "dye", "pressure")


@pytest.fixture
def four_cards():
    """cuda:0-3; skips the test where there are fewer (decided at run time)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA GPUs (the sharded step across cards)")
    return [torch.device("cuda", i) for i in range(4)]


def start(cfg: FluidConfig) -> FluidState:
    """A seeded state with flow everywhere, so that every backtrace moves."""
    g = torch.Generator().manual_seed(11)
    s = init_state(cfg, device="cpu")
    return FluidState(velocity=(300 * torch.randn(s.velocity.shape, generator=g)).to(cfg.dtype),
                      dye=torch.rand(s.dye.shape, generator=g).to(cfg.dtype),
                      pressure=torch.randn(s.pressure.shape, generator=g).to(cfg.dtype))


@pytest.mark.parametrize("overlap", [None, True], ids=["monolithic", "split-phase"])
def test_four_cards_equal_one_card_bit_for_bit(overlap, four_cards):
    """4096^2 bf16 RGB9E5, MESH 2x2, 3 steps: shards on cuda:0-3 against
    the same four shards all on cuda:0, every field bit for bit, with the
    same launches either way."""
    cfg = FluidConfig(SIM_RESOLUTION=4096, DYE_RESOLUTION=4096, CANVAS_WIDTH=4096,
                      CANVAS_HEIGHT=4096, DTYPE="bfloat16", DYE_RGB9E5=True, MAX_SPLATS=8,
                      OVERLAP_HALO=overlap).validate()
    trace = swirl_trace(cfg, 3, seed=4)
    whole = start(cfg)
    out = {}
    for name, devices in (("cards", four_cards), ("one", [four_cards[0]] * 4)):
        mesh = make_mesh(devices=devices, shape=(2, 2))
        multi = make_sharded_multi_step(cfg, mesh)
        shards = shard_state(whole, mesh)
        build.reset_launches()
        shards = multi(shards, trace.dts, trace.batches)
        for d in four_cards:
            torch.cuda.synchronize(d)
        out[name] = (gather_state(shards, "cpu"), sum(k.launches for k in build.KERNELS.values()))
        assert {s.velocity.device for row in shards for s in row} == set(devices)
    (a, na), (b, nb) = out["cards"], out["one"]
    assert na == nb > 0
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert bool(torch.isfinite(x.float()).all()), f
        assert torch.equal(x, y), (f, float((x.float() - y.float()).abs().max()))


def test_a_launch_stream_is_its_cards_current_stream(four_cards):
    """build.stream(t) is the current stream of t's card, the default one
    and a side stream alike, whichever card is current; only a card other
    than the current one asks Kernel for a switch."""
    for d in four_cards:
        t = torch.zeros(4, device=d)
        side = torch.cuda.Stream(device=d)
        for s in (torch.cuda.current_stream(d), side):
            with torch.cuda.stream(s):
                got = build.stream(t)
                assert (got.value or 0) == s.cuda_stream       # the null stream reads None
                assert got.device == (None if d.index == torch.cuda.current_device()
                                      else d.index)
    with torch.cuda.device(four_cards[2]):
        assert build.stream().device is None
        assert (build.stream().value or 0) == torch.cuda.current_stream(four_cards[2]).cuda_stream
