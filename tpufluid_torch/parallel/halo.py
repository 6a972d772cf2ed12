"""Halo exchange between the blocks of a sharded grid, for one controlling
process.

Counterpart of tpufluid/parallel/halo.py. There, every device runs the same
body and ``lax.ppermute`` passes a block's edge strips to its mesh
neighbours; here one process holds the blocks of a row or a column of
shards (a list in mesh order) and hands each shard the neighbours' strips:
a slice of the neighbour's block, copied to the shard's device by
``Tensor.to(device, non_blocking=True)`` (PyTorch orders a copy between two
cards on both cards' current streams; on one device it is the slice
itself). Every 5-point stencil needs one ghost row or column from each
neighbour, the advection's backtrace ``ceil(max|v| dt)`` (bounded by the
reference's +/-1000 velocity clamp). At the global walls the ghost is the
edge row or column replicated, the clamp-to-edge of the single-device
kernels.

A block already held in a buffer of its padded width (the sharded step's
own pass outputs) is padded in place (``exchange_halo_into``): only its
ghost slices are written, the same values ``exchange_halo`` would put
around it; ``PADS`` counts the sharded step's column pads of each kind.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from tpufluid_torch import spans


class Traffic:
    """Bytes of the strips that shards received from other shards (the
    edge replicas at the walls are a shard's own and count nothing)."""

    def __init__(self):
        self.bytes = 0

    def reset(self) -> None:
        self.bytes = 0


SENT = Traffic()
spans.count_sent(SENT)      # each span records the bytes sent inside it


class Pads:
    """The sharded step's column pads, one a block: ``in_place``, the
    ghost columns written into the padded buffer that already holds the
    block (exchange_halo_into); ``fresh``, the block and its ghosts
    concatenated into a new buffer (exchange_halo)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.in_place = 0
        self.fresh = 0


PADS = Pads()


def _first(x: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    return x[..., :k, :] if axis == -2 else x[..., :k]


def _last(x: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    return x[..., -k:, :] if axis == -2 else x[..., -k:]


def _send(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    SENT.bytes += x.numel() * x.element_size()
    return x.to(device, non_blocking=True)


def _wall(block: torch.Tensor, own: bool, k: int, axis: int, first: bool,
          device: torch.device) -> torch.Tensor:
    """``k`` copies on ``device`` of the wall slice of the wall's ``block``
    (``own``: the receiving shard's block, so nothing moves)."""
    edge = _first(block, 1, axis) if first else _last(block, 1, axis)
    edge = edge if own else _send(edge, device)
    shape = list(edge.shape)
    shape[axis] = k
    return edge.expand(shape)


def ghost_strips(blocks: Sequence[torch.Tensor], width: int,
                 axis: int = -2) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The two ghost strips of every block of a row or column of shards
    along ``axis`` (-2 rows, -1 columns), without concatenating them onto
    the blocks: ``[(ghost_below, ghost_above), ...]`` in mesh order, each
    ``width`` slices on its block's device.

    ``ghost_below`` of block k holds the slices just before it in global
    order (block k-1's last ones; the global first slice replicated for
    block 0), ``ghost_above`` those just after it (block k+1's first ones;
    the last slice replicated for the last block). The split-phase step
    computes its interior band without them and assembles thin boundary
    strips from them; ``exchange_halo`` concatenates them.

    ``width`` may exceed a block's extent (the dye's halo at a large
    dye/sim ratio): the strips then chain ceil(width / extent) blocks, block
    k seeing blocks k-1 .. k-hops and k+1 .. k+hops, and a chain that runs
    past a wall carries the edge-replicated block: clamp-to-edge, as the
    JAX package's multi-hop ppermute chain gives."""
    if axis not in (-1, -2):
        raise ValueError(f"axis must be -2 (rows) or -1 (columns), got {axis}")
    n = len(blocks)
    loc = blocks[0].shape[axis]
    hops = -(-width // loc)
    out = []
    for k, x in enumerate(blocks):
        dev = x.device
        if hops == 1:
            below = (_wall(x, True, width, axis, True, dev) if k == 0
                     else _send(_last(blocks[k - 1], width, axis), dev))
            above = (_wall(x, True, width, axis, False, dev) if k == n - 1
                     else _send(_first(blocks[k + 1], width, axis), dev))
        else:
            # Hop j brings block k - j (k + j), or past a wall the global
            # edge slice replicated; only the slices of the strip move.
            below_parts, above_parts = [], []
            for j in range(1, hops + 1):
                take = min(loc, width - (j - 1) * loc)
                below_parts.append(_send(_last(blocks[k - j], take, axis), dev) if k - j >= 0
                                   else _wall(blocks[0], k == 0, take, axis, True, dev))
                above_parts.append(_send(_first(blocks[k + j], take, axis), dev) if k + j < n
                                   else _wall(blocks[-1], k == n - 1, take, axis, False, dev))
            below = torch.cat(below_parts[::-1], dim=axis)
            above = torch.cat(above_parts, dim=axis)
        out.append((below, above))
    return out


def exchange_halo(blocks: Sequence[torch.Tensor], width: int, axis: int) -> List[torch.Tensor]:
    """Every block of a row or column of shards padded with ``width`` ghost
    slices on each side along ``axis`` (-2 rows, -1 columns); see
    ghost_strips for what the ghosts hold."""
    return [torch.cat([below, x, above], dim=axis)
            for x, (below, above) in zip(blocks, ghost_strips(blocks, width, axis))]


def _wall_ghosts(x: torch.Tensor, k: int, axis: int, first: bool, mirror: bool) -> torch.Tensor:
    """The ``k`` ghost slices past the wall at a block's first (last)
    slice: its edge slice replicated, or with ``mirror`` the mirror of its
    own ``k`` slices (global -k := k - 1, the far wall alike)."""
    if mirror:
        return torch.flip(_first(x, k, axis) if first else _last(x, k, axis), dims=(axis,))
    return _wall(x, True, k, axis, first, x.device)


def exchange_halo_into(pads: Sequence[torch.Tensor], blocks: Sequence[torch.Tensor], width: int,
                       axis: int, mirror: bool = False) -> List[torch.Tensor]:
    """exchange_halo written into buffers that already hold the blocks:
    ``pads[k]`` is ``width`` slices wider than ``blocks[k]`` on each side
    along ``axis``, with blocks[k] its centre, and only its ghost slices are
    written: a neighbour's strip copied in (counted as _send counts it; a
    copy between two cards waits on both cards' current streams), at a
    wall the edge slice replicated or, with ``mirror``, the mirrored strip.
    Each padded block then equals exchange_halo's (_mirrored_pad's), value
    for value. Single hop only. Returns ``pads``."""
    if width > blocks[0].shape[axis]:
        raise ValueError("the in-place exchange is single-hop: a ghost deeper than a shard "
                         "takes exchange_halo")
    n = len(blocks)
    for k, (pad, x) in enumerate(zip(pads, blocks)):
        below, above = _first(pad, width, axis), _last(pad, width, axis)
        below.copy_(_wall_ghosts(x, width, axis, True, mirror) if k == 0
                    else _send(_last(blocks[k - 1], width, axis), pad.device))
        above.copy_(_wall_ghosts(x, width, axis, False, mirror) if k == n - 1
                    else _send(_first(blocks[k + 1], width, axis), pad.device))
    return list(pads)


def exchange_halo_rows(blocks: Sequence[torch.Tensor], width: int) -> List[torch.Tensor]:
    """Row halo exchange over a column of shards (mesh axis ROW_AXIS):
    (..., h, W) -> (..., h + 2 width, W) each."""
    return exchange_halo(blocks, width, -2)


def exchange_halo_cols(blocks: Sequence[torch.Tensor], width: int) -> List[torch.Tensor]:
    """Column halo exchange over a row of shards (mesh axis COL_AXIS):
    (..., H, w) -> (..., H, w + 2 width) each."""
    return exchange_halo(blocks, width, -1)
