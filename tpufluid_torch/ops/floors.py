"""The three reference-rate microbenchmarks of the profiling path: plain
PyTorch versions and their inputs.

Counterparts of tpufluid/ops/pallas/floors.py's `_taa_kernel` (:92),
`_roll_kernel` (:133) and `_sweep_kernel` (:163): reduced structures of the
step's own inner loops (a bare row gather, a bare trip-staging roll, a bare
Jacobi sweep chain), whose rates stand beside the step's kernels in the
floor report (ops/cuda/floors.py). The CUDA kernels are csrc/floors.cu.

PyTorch has no add for torch.uint32 on the CPU, so uint32 words travel as
int32 tensors holding the same bits; the plain versions sum them in int64
and wrap to 32 bits at the end, which gives the bits of uint32 arithmetic
(addition mod 2^32 is associative, so the order of the adds does not
matter). Compare results through ``numpy().view(np.uint32)``.
"""

from __future__ import annotations

import torch

from tpufluid_torch.ops import stencil as S

ROWS = 64     # the microbenchmarks' tile rows (floors.py _R)
LANE = 128    # words per gathered row

_MASK = 0xFFFFFFFF


def _u64(words: torch.Tensor) -> torch.Tensor:
    """int32 words holding uint32 bits -> their unsigned values as int64."""
    return words.to(torch.int64) & _MASK


def _wrap32(acc: torch.Tensor) -> torch.Tensor:
    """int64 sums -> int32 words holding the low 32 bits."""
    acc = acc & _MASK
    return torch.where(acc >= 2 ** 31, acc - 2 ** 32, acc).to(torch.int32)


def taa_inputs(planes: int = 2, n_idx: int = 8, reps: int = 32, device="cpu"):
    """(seed, idx, op) as floors.py:115-119 and :129 build them: a zero
    (64, 128) seed; n_idx lane permutations idx[j][r, c] = (c * (j + 3)) mod
    128; op = arange(planes * (64 + reps) * 128) as (planes, 64 + reps, 128)."""
    lanes = torch.arange(LANE, dtype=torch.int32, device=device)
    idx = torch.stack([((lanes * (j + 3)) % LANE).expand(ROWS, LANE)
                       for j in range(n_idx)]).contiguous()
    op = torch.arange(planes * (ROWS + reps) * LANE, dtype=torch.int32,
                      device=device).reshape(planes, ROWS + reps, LANE)
    seed = torch.zeros((ROWS, LANE), dtype=torch.int32, device=device)
    return seed, idx, op


def taa_plain(seed: torch.Tensor, idx: torch.Tensor, op: torch.Tensor, trips: int,
              reps: int) -> torch.Tensor:
    """``trips`` times, for each rep < reps, j < n_idx and plane ch, add
    take_along_axis(op[ch, rep:rep + 64, :], idx[j], axis=1) into the
    (64, 128) words of ``seed`` (floors.py:92-106). Each trip adds the same
    sum, so it is taken once, over all reps and planes at a time, and added
    ``trips`` times."""
    rows = seed.shape[0]
    # windows[ch, rep, r, :] = op[ch, rep + r, :]
    windows = _u64(op).unfold(1, rows, 1)[:, :reps].transpose(2, 3)
    trip = torch.zeros(seed.shape, dtype=torch.int64, device=seed.device)
    for j in range(idx.shape[0]):
        cols = idx[j].to(torch.int64).expand_as(windows)
        trip = trip + torch.gather(windows, 3, cols).sum(dim=(0, 1))
    return _wrap32(_u64(seed) + trips * (trip & _MASK))


def roll_inputs(planes: int, nrk: int, cbw: int, device="cpu"):
    """(seed, op) as floors.py:148 and :159 build them: a zero seed and
    op = arange(planes * nrk * cbw) as (planes, nrk, cbw)."""
    op = torch.arange(planes * nrk * cbw, dtype=torch.int32,
                      device=device).reshape(planes, nrk, cbw)
    return torch.zeros_like(op), op


def roll_plain(seed: torch.Tensor, op: torch.Tensor, trips: int) -> torch.Tensor:
    """seed + sum over k < trips of roll(op, k mod nrk, axis=1), where
    roll(x, s)[i] = x[(i - s) mod nrk], the direction of pltpu.roll
    (floors.py:133-140). The trips are grouped by shift: shift s recurs
    trips // nrk times, once more for s < trips mod nrk."""
    nrk = op.shape[1]
    shifts = torch.arange(min(trips, nrk), device=op.device)
    counts = trips // nrk + (shifts < trips % nrk).to(torch.int64)
    rows = (torch.arange(nrk, device=op.device)[None, :] - shifts[:, None]) % nrk
    rolled = _u64(op)[:, rows]                          # (planes, shifts, nrk, cbw)
    return _wrap32(_u64(seed) + (rolled * counts[None, :, None, None]).sum(dim=1))


SWEEP_SHAPE = (256, 1024)   # measure_sweep_rate's field (floors.py:184)


def sweep_inputs(h: int = SWEEP_SHAPE[0], w: int = SWEEP_SHAPE[1], device="cpu"):
    """(seed, x) as floors.py:186 and :196 build them: x = ones, seed = x * 0.5."""
    x = torch.ones((h, w), dtype=torch.float32, device=device)
    return x * 0.5, x


def sweep_plain(seed: torch.Tensor, x: torch.Tensor, chunks: int, sweeps: int) -> torch.Tensor:
    """chunks * sweeps clamped-edge sweeps of a float32 field:
    p = ((((p[i, j-1] + p[i, j+1]) + p[i-1, j]) + p[i+1, j]) - x) * 0.25,
    in floors.py:171-175's order (edge_shift's neighbours are self at the
    edge)."""
    p = seed
    for _ in range(chunks * sweeps):
        L, R, T, B = S.neighbors_clamped(p)
        p = ((((L + R) + B) + T) - x) * 0.25
    return p
