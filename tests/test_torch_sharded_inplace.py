"""The sharded step's column pads written in place (tpufluid_torch/parallel)
on the CPU, through the plain passes on a 2x2 mesh of CPU shards.

A pass's output is the column-padded block, of which the step keeps the
centre; the next column pad of that centre writes the ghost columns into
the output instead of concatenating the block anew. Held here: the in-place
exchange equals the concatenating one value for value (halo level); three
steps with it equal three steps with every pad concatenated, bit for bit,
in both forms, on one grid and across grids, for one sim and a batch of two;
halo.PADS counts 5 pads in place and 3 fresh a shard on a step from
shard_state's blocks, then 8 and 0; and a caller's tensors are never
written: shards that are views of one whole grid leave it byte for byte.
"""

import pytest
import torch

from tpufluid_torch import FluidConfig, init_state, shard_state, swirl_trace
from tpufluid_torch.batch import make_batch_spatial_mesh, make_batch_spatial_multi_step
from tpufluid_torch.parallel import halo, sharded_step
from tpufluid_torch.parallel.mesh import gather_state, make_mesh
from tpufluid_torch.state import FluidState

FIELDS = ("velocity", "dye", "pressure")
GRIDS = {"same": dict(SIM_RESOLUTION=256, DYE_RESOLUTION=256),
         "cross": dict(SIM_RESOLUTION=256, DYE_RESOLUTION=512)}
SHARDS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch intra-op thread for this module: the suite runs files in
    parallel workers, and each worker's full thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(overlap, grid="same") -> FluidConfig:
    """bf16 with the RGB9E5 dye, as the 32768^2 cell; at 256^2 on a 2x2 mesh
    every phase takes the split form with OVERLAP_HALO."""
    return FluidConfig(CANVAS_WIDTH=256, CANVAS_HEIGHT=256, DTYPE="bfloat16", DYE_RGB9E5=True,
                       MAX_SPLATS=8, OVERLAP_HALO=overlap, **GRIDS[grid]).validate()


def start(cfg: FluidConfig, sims: int = 1) -> FluidState:
    """A seeded state with flow everywhere (B leading where ``sims`` > 1)."""
    g = torch.Generator().manual_seed(11)
    s = init_state(cfg, device="cpu")
    lead = (sims,) if sims > 1 else ()

    def field(x, scale, rand):
        return (scale * rand(lead + tuple(x.shape), generator=g)).to(cfg.dtype)

    return FluidState(velocity=field(s.velocity, 300.0, torch.randn),
                      dye=field(s.dye, 1.0, torch.rand),
                      pressure=field(s.pressure, 1.0, torch.randn))


def mesh():
    return make_mesh(devices=["cpu"] * SHARDS, shape=(2, 2))


def never_owned(monkeypatch):
    """Every column pad concatenated anew: the step before pads in place."""
    monkeypatch.setattr(sharded_step, "_owned", lambda x, width: None)


# ---------------------------------------------------------------- halo


@pytest.mark.parametrize("mirror", [False, True], ids=["edge", "mirror"])
@pytest.mark.parametrize("axis", [-1, -2], ids=["cols", "rows"])
def test_the_in_place_exchange_equals_the_concatenating_one(axis, mirror):
    """Three blocks of a line, each the centre of a buffer of its padded
    width filled with NaN: after exchange_halo_into each buffer equals
    exchange_halo's block (_mirrored_pad's with ``mirror``), the same
    bytes counted sent, and no centre written."""
    g = torch.Generator().manual_seed(3)
    blocks = [torch.randn(2, 6, 7, generator=g) for _ in range(3)]
    width = 3
    halo.SENT.reset()
    want = (sharded_step._mirrored_pad(blocks, width, axis) if mirror
            else halo.exchange_halo(blocks, width, axis))
    sent = halo.SENT.bytes
    pads, centres = [], []
    for x in blocks:
        shape = list(x.shape)
        shape[axis] += 2 * width
        pad = torch.full(shape, float("nan"))
        centre = pad.narrow(axis, width, x.shape[axis])
        centre.copy_(x)
        pads.append(pad)
        centres.append(centre)
    halo.SENT.reset()
    got = halo.exchange_halo_into(pads, centres, width, axis, mirror)
    assert halo.SENT.bytes == sent > 0
    for p, q, x, c in zip(got, want, blocks, centres):
        assert torch.equal(p, q)
        assert torch.equal(c, x)


def test_the_in_place_exchange_is_single_hop():
    blocks = [torch.zeros(1, 4, 2) for _ in range(2)]
    pads = [torch.zeros(1, 4, 8) for _ in range(2)]
    with pytest.raises(ValueError, match="single-hop"):
        halo.exchange_halo_into(pads, blocks, 3, -1)


# ---------------------------------------------------------------- the step


def run_steps(cfg: FluidConfig, sims: int, steps: int = 3):
    """``steps`` sharded steps from start(), each fed the last one's state:
    the gathered state and the column pads of each kind."""
    trace = swirl_trace(cfg, steps, seed=5)
    halo.PADS.reset()
    whole = start(cfg, sims)
    if sims == 1:
        m = mesh()
        shards = shard_state(whole, m)
        for t in range(steps):
            shards = sharded_step.plain_sharded_step(shards, trace.dts[t], trace.batches[t], cfg)
        out = gather_state(shards)
    else:
        bm = make_batch_spatial_mesh((1, 2, 2), devices=["cpu"] * SHARDS)
        multi = make_batch_spatial_multi_step(cfg, bm, plain=True)
        batches = torch.as_tensor(trace.batches)[:, None].expand(-1, sims, -1, -1)
        (shards,) = multi((shard_state(whole, bm.groups[0]),), trace.dts[:steps], batches)
        out = gather_state(shards)
    return out, (halo.PADS.in_place, halo.PADS.fresh)


@pytest.mark.parametrize("sims", [1, 2], ids=["B1", "B2"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("overlap", [False, True], ids=["monolithic", "split-phase"])
def test_in_place_column_pads_equal_fresh_ones_bit_for_bit(overlap, grid, sims, monkeypatch):
    """Three steps as built against three with every column pad a fresh
    concatenation: velocity, dye and pressure equal bit for bit. The split
    form pads in place from its first step; the monolithic form, which
    row-pads first, never does."""
    cfg = config(overlap, grid)
    got, (in_place, fresh) = run_steps(cfg, sims)
    never_owned(monkeypatch)
    want, (in_place_0, fresh_0) = run_steps(cfg, sims)
    assert in_place_0 == 0 and fresh_0 == in_place + fresh > 0
    assert (in_place > 0) == overlap
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert bool(torch.isfinite(a.float()).all()), f
        assert torch.equal(a, b), (f, float((a.float() - b.float()).abs().max()))


def test_the_counter_reads_5_in_place_and_3_fresh_a_shard_then_8_and_0():
    """From shard_state's blocks the step's own input velocity, pressure and
    dye are concatenated anew and its five other column pads written in
    place; every later step pads all eight in place."""
    cfg = config(True)
    trace = swirl_trace(cfg, 3, seed=5)
    shards = shard_state(start(cfg), mesh())
    counts = []
    for t in range(3):
        halo.PADS.reset()
        shards = sharded_step.plain_sharded_step(shards, trace.dts[t], trace.batches[t], cfg)
        counts.append((halo.PADS.in_place, halo.PADS.fresh))
    assert counts == [(5 * SHARDS, 3 * SHARDS), (8 * SHARDS, 0), (8 * SHARDS, 0)]


def test_shards_that_are_views_of_a_whole_grid_never_write_it():
    """Shards cut as views of one whole-grid state: two steps leave that
    state byte for byte as it was, its blocks' pads count fresh, and the
    result equals the step from shard_state's copies bit for bit."""
    cfg = config(True)
    trace = swirl_trace(cfg, 2, seed=5)
    whole = start(cfg)
    before = [getattr(whole, f).clone() for f in FIELDS]

    def view(x, i, j):
        h, w = x.shape[-2] // 2, x.shape[-1] // 2
        return x[..., i * h:(i + 1) * h, j * w:(j + 1) * w]

    views = tuple(tuple(FluidState(*(view(getattr(whole, f), i, j) for f in FIELDS))
                        for j in range(2)) for i in range(2))
    assert not views[0][0].velocity.is_contiguous()
    copies = shard_state(whole, mesh())
    halo.PADS.reset()
    shards = sharded_step.plain_sharded_step(views, trace.dts[0], trace.batches[0], cfg)
    assert (halo.PADS.in_place, halo.PADS.fresh) == (5 * SHARDS, 3 * SHARDS)
    shards = sharded_step.plain_sharded_step(shards, trace.dts[1], trace.batches[1], cfg)
    for f, b in zip(FIELDS, before):
        a = getattr(whole, f)
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), f
    for t in range(2):
        copies = sharded_step.plain_sharded_step(copies, trace.dts[t], trace.batches[t], cfg)
    got, want = gather_state(shards), gather_state(copies)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_a_buffer_given_for_two_shards_is_padded_once_in_place():
    """The same step output passed as two shards' blocks: the first row
    that holds it pads it in place, any other takes a fresh concatenation,
    so no pass reads ghosts another shard's pad wrote."""
    out = torch.randn(1, 8, 6 + 2 * 4)
    block = sharded_step._crop(out, 0, 4, 8, 6)
    other = sharded_step._crop(torch.randn(1, 8, 6 + 2 * 4), 0, 4, 8, 6)
    halo.PADS.reset()
    grid = [[block, other], [other, block]]
    padded = sharded_step._colpad(grid, 4)
    assert padded[0][0] is out and (halo.PADS.in_place, halo.PADS.fresh) == (2, 2)
    assert padded[1][1] is not out
    want = halo.exchange_halo([other, block], 4, -1)
    for p, q in zip(padded[1], want):
        assert torch.equal(p, q)
    assert sharded_step._owned(block, 4) is out and sharded_step._owned(block, 2) is None
    assert sharded_step._owned(out[..., 4:10], 4) is None
