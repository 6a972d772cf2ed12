"""The designs of floor_taa, floor_roll and floor_sweep (csrc/floors.cu) on
the CPU.

Neither kernel runs here, so what surrounds them is held instead: the plans
of ops/cuda/floors.py (taa_plan: every (trip, rep) term of every word in
exactly one block; roll_plan: every (word, trip) in exactly one thread;
sweep_plan: tiles that cover the field within the SMs),
and a torch model of each kernel's decomposition, which must equal the
plain version (ops/floors.py) bit for bit on the microbenchmarks' own
inputs and on check.random_floors_cases:
- floor_taa: each block's partial over its rows, reps and trips, wrapped to
  32 bits, added to the seed in the plan's order;
- floor_roll: each thread's R rows of one column of its block's strip, its
  window of R words sliding down one row a trip, one word loaded a trip;
  each split's partials, wrapped, added to the seed;
- floor_sweep: the plan's tiles, each in a region with a halo as deep as a
  phase's sweeps, the neighbours' bands published and the ring reloaded
  every phase, the sweep's neighbours clamped at the grid's edge as the
  kernel clamps them. A halo one cell short must differ.
The kernels themselves are held to the plain versions on the card
(chip_smoke.py, tests/test_torch_kernels.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpufluid_torch.ops import floors as pf
from tpufluid_torch.ops.cuda import check
from tpufluid_torch.ops.cuda import floors as fk

MASK = 0xFFFFFFFF


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch intra-op thread for this module: the suite runs files in
    parallel workers, and each worker's full thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# ---- floor_taa -----------------------------------------------------------

TAA_SHAPES = {"default": (check.TAA_DEFAULT, (pf.ROWS, pf.LANE)),
              "ragged": (check.TAA_RAGGED, (pf.ROWS, pf.LANE)),
              "ragged_tile": (check.TAA_RAGGED, check.TAA_RAGGED_TILE)}


def _coverage(plan: fk.TaaPlan, words, parts) -> np.ndarray:
    """How many (block, split) threads of ``plan`` take each term (word,
    trip * reps + rep), over the blocks' ``words`` and the splits' ``parts``."""
    count = np.zeros((plan.rows * plan.lanes, plan.trips * plan.reps), np.int64)
    for w0, w1 in words:
        for q0, q1 in parts:
            count[w0:w1, q0:q1] += 1
    return count


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("shape", list(TAA_SHAPES))
def test_taa_plan_covers_every_pair_once(shape, sms):
    """Every (trip, rep) pair of every word in exactly one thread; the
    threads, the offsets a thread keeps and the staging fit a launch; a
    plan that drops or repeats a block or a split fails the count."""
    (planes, n_idx, reps, trips), (rows, lanes) = TAA_SHAPES[shape]
    plan = fk.taa_plan(planes, n_idx, reps, trips, rows, lanes, sms)
    words, parts = list(plan.words()), list(plan.parts())
    assert (_coverage(plan, words, parts) == 1).all()
    assert not (_coverage(plan, words[:-1], parts) == 1).all()
    assert not (_coverage(plan, words + words[-1:], parts) == 1).all()
    assert not (_coverage(plan, words, parts[1:]) == 1).all()
    assert not (_coverage(plan, words, parts + parts[:1]) == 1).all()
    assert len(words) == plan.blocks and plan.threads <= 1024
    spanned = max((w1 - 1) // lanes - w0 // lanes + 1 for w0, w1 in words)
    assert plan.smem == 4 * (planes * (spanned + reps - 1) * lanes
                             + (n_idx + plan.splits) * plan.words_b) <= fk.TAA_MAX_SMEM
    assert plan.splits in fk.TAA_SPLITS and plan.words_b % 32 == 0   # a warp, one split


def test_taa_plan_splits_and_raises():
    """The split that leaves the fewest words on the busiest SM, the
    fewest splits of equals; an explicit split is taken; a split past the
    terms or off the list, an empty size and a staging past shared memory
    raise."""
    plan = fk.taa_plan(2, 8, 32, 8, 64, 128, 132)
    # 128 blocks of 64 words: 64 words on the busiest SM (16 splits: 2 x 32)
    assert (plan.splits, plan.words_b, plan.blocks, plan.threads) == (8, 64, 128, 512)
    assert fk.taa_plan(2, 8, 32, 8, 64, 128, 7).splits == 16
    assert fk.taa_plan(3, 5, 7, 3, 37, 100, 132).splits == 16
    assert fk.taa_plan(2, 8, 32, 8, 64, 128, 132, splits=4).blocks == 64
    assert fk.taa_plan(1, 1, 2, 2, 4, 8, 132).splits == 4   # every term its thread
    with pytest.raises(ValueError, match="threads, not"):
        fk.taa_plan(2, 8, 2, 2, 64, 128, 132, splits=8)
    with pytest.raises(ValueError, match="threads, not"):
        fk.taa_plan(2, 8, 32, 8, 64, 128, 132, splits=9)
    with pytest.raises(ValueError, match=">= 1"):
        fk.taa_plan(2, 0, 4, 8, 64, 128, 132)
    with pytest.raises(ValueError, match="stages"):
        fk.taa_plan(64, 8, 4096, 1, 64, 128, 1, splits=1)


def _taa_model(seed, idx, op, trips, plan: fk.TaaPlan) -> torch.Tensor:
    """floor_taa's decomposition: per rep, the gathers of every j and plane
    for every word; each split's partial, the sum of its terms (trip, rep)
    for its block's words, wrapped to 32 bits; the seed plus the splits'
    partials in order, wrapped."""
    rows = seed.shape[0]
    windows = pf._u64(op).unfold(1, rows, 1)[:, :plan.reps].transpose(2, 3)
    per_rep = torch.zeros((plan.reps, *seed.shape), dtype=torch.int64)
    for j in range(idx.shape[0]):
        cols = idx[j].to(torch.int64).clamp(0, seed.shape[1] - 1).expand_as(windows)
        per_rep += torch.gather(windows, 3, cols).sum(dim=0)
    per_rep = per_rep.reshape(plan.reps, -1)
    out = pf._u64(seed).reshape(-1).clone()
    for w0, w1 in plan.words():
        for q0, q1 in plan.parts():
            part = torch.zeros(w1 - w0, dtype=torch.int64)
            for q in range(q0, q1):
                part = (part + per_rep[q % plan.reps, w0:w1]) & MASK
            out[w0:w1] = (out[w0:w1] + part) & MASK
    return pf._wrap32(out.reshape(seed.shape))


def _taa_cases():
    out = []
    for ragged in (False, True):
        out += [(c.label, c.args) for c in check.floors_cases("cpu", ragged)[:1]]
        out += [(c.label, c.args) for c in check.random_floors_cases("cpu", ragged)[:1]]
    return dict(out)


TAA_CASES = _taa_cases()


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("label", list(TAA_CASES))
def test_taa_model_matches_plain(label, sms):
    seed, idx, op, trips, reps = TAA_CASES[label]
    plan = fk.taa_plan(op.shape[0], idx.shape[0], reps, trips, *seed.shape, sms)
    got = _taa_model(seed, idx, op, trips, plan)
    want = pf.taa_plain(seed, idx, op, trips, reps)
    np.testing.assert_array_equal(_u32(got), _u32(want))


# ---- floor_roll ----------------------------------------------------------

ROLL_SHAPES = {"default": check.ROLL_DEFAULT, "ragged": check.ROLL_RAGGED,
               "short": (2, 3, 40, 7)}     # fewer rows than a thread's window


def _roll_coverage(plan: fk.RollPlan, blocks, parts) -> np.ndarray:
    """How many threads of ``plan`` take each (plane, row, column, trip),
    over the blocks' words ``blocks`` and the splits' ``parts``."""
    count = np.zeros((plan.planes, plan.nrk, plan.cbw, plan.trips), np.int64)
    for plane, (r0, r1), (c0, c1) in blocks:
        for k0, k1 in parts:
            count[plane, r0:r1, c0:c1, k0:k1] += 1
    return count


@pytest.mark.parametrize("rows", fk.ROLL_ROWS)
@pytest.mark.parametrize("sms", [132, 16, 1])
@pytest.mark.parametrize("shape", list(ROLL_SHAPES))
def test_roll_plan_covers_every_word_and_trip_once(shape, sms, rows):
    """Every trip of every word in exactly one thread, at the default, the
    ragged shape and one shorter than a window, on 132, 16 and 1 SMs; a
    plan that drops or repeats a block or a split fails the count; the
    threads and the staging fit a block."""
    plan = fk.roll_plan(*ROLL_SHAPES[shape], sms, rows=rows)
    blocks, parts = list(plan.words()), list(plan.parts())
    assert (_roll_coverage(plan, blocks, parts) == 1).all()
    assert not (_roll_coverage(plan, blocks[:-1], parts) == 1).all()
    assert not (_roll_coverage(plan, blocks + blocks[:1], parts) == 1).all()
    if plan.splits > 1:
        assert not (_roll_coverage(plan, blocks, parts[1:]) == 1).all()
    assert not (_roll_coverage(plan, blocks, parts + parts[:1]) == 1).all()
    assert len(blocks) == plan.blocks and plan.threads <= fk.ROLL_MAX_THREADS
    assert plan.r == rows and plan.splits in fk.ROLL_SPLITS and plan.splits <= plan.trips
    assert plan.smem == 4 * fk.ROLL_STRIP * (plan.nrk + (plan.splits - 1) * plan.groups_b
                                             * rows) <= fk.TAA_MAX_SMEM


def test_roll_plan_default_and_raises():
    """The default (2, 96, 384) with 256 trips on 132 SMs: 8 rows a thread,
    4 splits (1,152 warps, 8 or more an SM), 3 row groups a block, 96
    blocks of 384 threads; with 4 rows, 2 splits and 5 groups, 120 blocks;
    an explicit split is taken; a split past the trips or off the list, a
    row count off the list, an empty size and a strip past shared memory
    raise."""
    plan = fk.roll_plan(*check.ROLL_DEFAULT, 132)
    assert (plan.r, plan.splits, plan.groups_b, plan.blocks, plan.threads) == (8, 4, 3, 96, 384)
    plan = fk.roll_plan(*check.ROLL_DEFAULT, 132, rows=4)
    assert (plan.splits, plan.groups_b, plan.blocks) == (2, 5, 120)
    assert fk.roll_plan(*check.ROLL_DEFAULT, 132, splits=1).splits == 1
    assert fk.roll_plan(2, 96, 384, 2, 132).splits == 2      # every trip its thread
    with pytest.raises(ValueError, match="threads, not"):
        fk.roll_plan(2, 96, 384, 2, 132, splits=4)
    with pytest.raises(ValueError, match="threads, not"):
        fk.roll_plan(*check.ROLL_DEFAULT, 132, splits=3)
    with pytest.raises(ValueError, match="rows a thread"):
        fk.roll_plan(*check.ROLL_DEFAULT, 132, rows=2)
    with pytest.raises(ValueError, match=">= 1"):
        fk.roll_plan(2, 0, 384, 256, 132)
    with pytest.raises(ValueError, match="stages"):
        fk.roll_plan(1, 2000, 32, 4, 132)


def _roll_model(seed, op, plan: fk.RollPlan) -> torch.Tensor:
    """floor_roll's decomposition, every thread at once: thread (block,
    split, group, lane) takes rows i0 .. i0 + R - 1 of its block's strip
    column and the split's trips [k0, k0 + n); its window w[j] starts as
    row (i0 + j - k0) mod nrk of the strip; each trip adds slot (j - t) mod
    R to row j, then loads the next row down (wrapping by a compare) into
    slot (R - 1 - t) mod R; past its trips a thread adds nothing. Split 0
    starts from the seed; the other splits' partials, wrapped, are added to
    its sum."""
    r, nrk = plan.r, plan.nrk
    ops = pf._u64(op)
    threads = []   # (plane, i0, column, k0, n, split)
    for plane, (r0, r1), (c0, c1) in plan.words():
        for s, (k0, k1) in enumerate(plan.parts()):
            for i0 in range(r0, r1, r):
                for c in range(c0, c1):
                    threads.append((plane, i0, c, k0, k1 - k0, s))
    t = torch.tensor(threads, dtype=torch.int64)
    plane, i0, col, k0, n, split = t.unbind(1)
    row = (i0 - k0) % nrk
    w = [ops[plane, (row + j) % nrk, col] for j in range(r)]
    seeds = pf._u64(seed)
    acc = [torch.where((split == 0) & (i0 + j < nrk),
                       seeds[plane, (i0 + j).clamp(max=nrk - 1), col], 0) for j in range(r)]
    off = row
    for trip in range(int(n.max())):
        live = trip < n
        for j in range(r):
            acc[j] = torch.where(live, (acc[j] + w[(j - trip) % r]) & MASK, acc[j])
        off = off - 1
        off = torch.where(off < 0, off + nrk, off)
        w[(r - 1 - trip) % r] = ops[plane, off, col]
    out = torch.zeros(seed.numel(), dtype=torch.int64)
    for j in range(r):
        rows = i0 + j
        keep = rows < nrk
        flat = (plane * nrk + rows) * plan.cbw + col
        out.index_add_(0, flat[keep], acc[j][keep])    # split 0 and the partials
    return pf._wrap32(out.reshape(seed.shape) & MASK)


def _roll_cases():
    out = {}
    for ragged in (False, True):
        for case in (check.floors_cases("cpu", ragged)[1],
                     check.random_floors_cases("cpu", ragged)[1]):
            out[case.label] = case.args
    return out


ROLL_CASES = _roll_cases()


@pytest.mark.parametrize("rows", fk.ROLL_ROWS)
@pytest.mark.parametrize("label", list(ROLL_CASES))
def test_roll_model_matches_plain(label, rows):
    """The plan's geometry at the case's own trips (default, ragged,
    random: check.floors_cases, check.random_floors_cases) on 132 SMs, 4
    and 8 rows a thread; and one split where the default cuts the trips."""
    seed, op, trips = ROLL_CASES[label]
    want = pf.roll_plain(seed, op, trips)
    for splits in (None, 1):
        plan = fk.roll_plan(*op.shape, trips, 132, rows=rows, splits=splits)
        np.testing.assert_array_equal(_u32(_roll_model(seed, op, plan)), _u32(want))


# ---- floor_sweep ---------------------------------------------------------


def _sweep_model(seed, x, plan: fk.SweepPlan, halo=None) -> torch.Tensor:
    """floor_sweep's decomposition, all tiles at once: each block's region
    is its tile and a ring ``halo`` cells deep (the plan's k), loaded once
    from the seed and x with indices clamped to the grid; a sweep takes
    each cell's left and right neighbours at the grid-clamped column, moved
    into the region, and the rows above and below inside the region (the
    cell itself at the grid's edge); after each phase but the last the
    tiles' cells within ``halo`` of their edge go to a band buffer and
    every ring cell of the grid comes back from it; the tiles are the
    output."""
    h, w = seed.shape
    halo = plan.k if halo is None else halo
    th, tw = plan.tile
    rh, rw = th + 2 * halo, tw + 2 * halo
    ty, tx = np.meshgrid(np.arange(plan.tiles_y), np.arange(plan.tiles_x), indexing="ij")
    r0 = torch.from_numpy(ty.reshape(-1, 1) * th - halo)            # (nb, 1)
    c0 = torch.from_numpy(tx.reshape(-1, 1) * tw - halo)
    gi = r0 + torch.arange(rh)                                       # (nb, rh)
    gj = c0 + torch.arange(rw)                                       # (nb, rw)
    nb = gi.shape[0]
    flat = gi.clamp(0, h - 1)[:, :, None] * w + gj.clamp(0, w - 1)[:, None, :]
    v = seed.reshape(-1)[flat]
    d = x.reshape(-1)[flat]
    jl = ((gj - 1).clamp(min=0) - c0).clamp(0, rw - 1)
    jr = ((gj + 1).clamp(max=w - 1) - c0).clamp(0, rw - 1)
    lr = torch.arange(rh).expand(nb, rh)
    below = torch.where(gi > 0, (lr - 1).clamp(min=0), lr)
    above = torch.where(gi + 1 < h, (lr + 1).clamp(max=rh - 1), lr)
    in_grid = ((gi >= 0) & (gi < h))[:, :, None] & ((gj >= 0) & (gj < w))[:, None, :]
    rows_t = (lr >= halo) & (lr < rh - halo)
    cols_t = (torch.arange(rw) >= halo) & (torch.arange(rw) < rw - halo)
    tile = rows_t[:, :, None] & cols_t[None, None, :]
    edge_rows = ((lr < 2 * halo) | (lr >= rh - 2 * halo))[:, :, None]
    edge_cols = (torch.arange(rw) < 2 * halo) | (torch.arange(rw) >= rw - 2 * halo)
    band = tile & (edge_rows | edge_cols[None, None, :])
    publish = band & in_grid
    ring = ~tile & in_grid
    for n, m in enumerate(plan.phases):
        if n:
            bands = torch.full((h * w,), float("nan"))
            bands[flat[publish]] = v[publish]
            v = torch.where(ring, bands[flat], v)
        for _ in range(m):
            L = torch.gather(v, 2, jl[:, None, :].expand(nb, rh, rw))
            R = torch.gather(v, 2, jr[:, None, :].expand(nb, rh, rw))
            B = torch.gather(v, 1, below[:, :, None].expand(nb, rh, rw))
            T = torch.gather(v, 1, above[:, :, None].expand(nb, rh, rw))
            v = ((((L + R) + B) + T) - d) * 0.25
    out = torch.full((h * w,), float("nan"))
    keep = tile & in_grid
    out[flat[keep]] = v[keep]
    return out.reshape(h, w)


def _sweep_cases():
    out = {}
    for ragged in (False, True):
        for case in (check.floors_cases("cpu", ragged)[2],
                     check.random_floors_cases("cpu", ragged)[2]):
            out[case.label] = case.args
    return out


SWEEP_CASES = _sweep_cases()


@pytest.mark.parametrize("label", list(SWEEP_CASES))
def test_sweep_model_matches_plain(label):
    """The plan's geometry at the case's own sweeps (default, ragged,
    random: check.floors_cases, check.random_floors_cases) on 132 SMs."""
    seed, x, chunks, sweeps = SWEEP_CASES[label]
    plan = fk.sweep_plan(*x.shape, chunks * sweeps, 132)
    assert plan.blocks <= 132 and sum(plan.phases) == chunks * sweeps
    got = _sweep_model(seed, x, plan)
    want = pf.sweep_plain(seed, x, chunks, sweeps)
    assert not torch.isnan(got).any()
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [1, 4, 20])
def test_sweep_model_every_k(k):
    """K sweeps a phase for K in {1, 4, 20}, totals K does not divide, on a
    random ragged field and a random 96x200 one (on 7 SMs where its K-deep
    halos fit that few blocks); the same plan with a halo one cell short
    differs where that shows in float32: a cell's error reaches K cells in
    weighted 4^-K, so at K = 20 it is under half an ulp of the field."""
    rng = np.random.default_rng(k)
    for (h, w), sms in (((37, 131), 132), ((96, 200), 7 if k < 20 else 132)):
        seed = torch.from_numpy(rng.random((h, w), dtype=np.float32))
        x = torch.from_numpy(rng.standard_normal((h, w), dtype=np.float32))
        total = 2 * k + 3 if k > 1 else 5
        plan = fk.sweep_plan(h, w, total, sms, k)
        assert plan.k == k and plan.blocks <= sms and plan.blocks > 1
        assert plan.barriers == -(-total // k) - 1 and sum(plan.phases) == total
        want = pf.sweep_plain(seed, x, total, 1)
        assert torch.equal(_sweep_model(seed, x, plan), want)
        if k < 20:
            assert not torch.equal(_sweep_model(seed, x, plan, halo=k - 1), want)


def test_sweep_plan_geometry_and_raises():
    """The default: at most one block an SM, tiles that cover the field,
    ceil(320 / K) - 1 barriers; a run shorter than K takes fewer sweeps a
    phase; a field past what 132 SMs hold on chip and an empty run
    raise."""
    plan = fk.sweep_plan(256, 1024, 320, 132)
    assert plan.k == fk.SWEEP_K
    assert plan.blocks <= 132 and plan.rw * plan.ny <= fk.SWEEP_MAX_THREADS
    assert plan.tiles_y * plan.tile[0] >= 256 and plan.tiles_x * plan.tile[1] >= 1024
    assert plan.barriers == -(-320 // plan.k) - 1
    assert plan.design_cell_sweeps() >= 256 * 1024 * 320
    ragged = fk.sweep_plan(37, 131, 6, 132)
    assert ragged.k == min(fk.SWEEP_K, 6) and sum(ragged.phases) == 6
    assert fk.sweep_plan(37, 131, 2, 132).k == 2
    with pytest.raises(ValueError, match="does not fit"):
        fk.sweep_plan(4096, 4096, 20, 132)
    with pytest.raises(ValueError, match="total >= 1"):
        fk.sweep_plan(37, 131, 0, 132)
