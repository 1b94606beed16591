"""The launch's compactions (twin of tropical_cyclone_risk_tpu/ops/compact.py
and of the takes and scatters around it in models/pipeline.py).

``stable_partition_order`` gives the permutation ``argsort(where(mask,
slot, slot + n))`` with one prefix sum and one scatter, bit for bit.
``partition_take`` is that order plus the row gathers, the overflow count
and the composed maps of one compaction site; ``stitch_survivors`` writes
the survivors' time-second track buffers out of the segments' time-major
ones.  On CPU tensors both run their plain twins (``*_plain``); on CUDA
tensors they launch K4 (csrc/compact.cu via kernels/compact.py) or raise.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from tropical_cyclone_risk_tpu_torch import kernels

# the survivor stitch's fields: five [T, w] buffers, then the [T, w, 4] winds
TRACK_FIELDS = ('lon', 'lat', 'v', 'm', 'vmax', 'wnds')


class Partition(NamedTuple):
    """One compaction of an [n] axis to its first k = min(w, n) slots of
    the stable partition order (partition_take)."""
    order: torch.Tensor               # [k] int64 slots, True class first
    overflow: torch.Tensor            # [1] int64: max(count - w, 0) (+ acc)
    rows: tuple                       # each input row tensor gathered
    slot_rank: Optional[torch.Tensor]  # [n] int64 rank of a slot, -1 if cut
    a_idx: Optional[torch.Tensor]     # [k] composed map: a_prev[order]
    inv: Optional[torch.Tensor]       # [inv_len] int64 position in new axis
    selected: Optional[torch.Tensor]  # [inv_len] bool: on the new axis


def stable_partition_order(mask: torch.Tensor, w: int | None = None):
    """[n] bool -> int64 order with the True slots first, each class in
    ascending slot order, truncated to the first ``w`` entries."""
    n = mask.shape[0]
    c = torch.cumsum(mask.to(torch.int64), 0)              # inclusive count
    slot = torch.arange(n, dtype=torch.int64, device=mask.device)
    rank = torch.where(mask, c - 1, c[-1] + slot - c)     # a permutation
    order = torch.empty_like(slot).index_put_((rank,), slot)
    return order if w is None or w >= n else order[:w]


def scatter_fill(m: int, idx, values, fill):
    """A length-m tensor holding `values` at the unique indices `idx` and
    `fill` elsewhere (jnp's .at[idx].set)."""
    out = torch.full((m,), fill, dtype=values.dtype, device=values.device)
    return out.index_put_((idx,), values)


def partition_take(mask: torch.Tensor, w: int,
                   rows: Sequence[torch.Tensor] = (),
                   acc: Optional[torch.Tensor] = None,
                   slot_rank: bool = False,
                   a_prev: Optional[torch.Tensor] = None,
                   inv_len: Optional[int] = None) -> Partition:
    """Compact the [n] axis of ``mask`` and of every row tensor ([n, ...]) to
    the first min(w, n) slots of the stable partition order.

    acc: a [1] int64 count the overflow is added to.  slot_rank: also
    return each slot's rank, or -1 where it falls past w.  inv_len: also
    compose the map to an outer axis of that length (a_prev [n] maps this
    axis there; None: this axis is the outer one) and return its inverse
    (each outer slot's position on the new axis, 0 if absent) and the
    outer slots that are on it."""
    if mask.device.type == 'cpu':
        return partition_take_plain(mask, w, rows, acc, slot_rank, a_prev,
                                    inv_len)
    from tropical_cyclone_risk_tpu_torch.kernels import compact as k4
    return k4.partition_cuda(mask, w, tuple(rows), acc, slot_rank, a_prev,
                             inv_len)


def partition_take_plain(mask, w, rows=(), acc=None, slot_rank=False,
                         a_prev=None, inv_len=None) -> Partition:
    """Plain twin of ``partition_take``."""
    if mask.is_cuda:
        kernels.PLAIN_ON_CUDA['compact'] += 1
    n = mask.shape[0]
    order = stable_partition_order(mask, w)
    k = order.shape[0]
    overflow = torch.clamp_min(mask.sum() - w, 0)[None]
    if acc is not None:
        overflow = acc + overflow
    pos = torch.arange(k, dtype=torch.int64, device=mask.device)
    rank = scatter_fill(n, order, pos, -1) if slot_rank else None
    a_idx = inv = sel = None
    if inv_len is not None:
        a_idx = order if a_prev is None else a_prev[order]
        inv = scatter_fill(inv_len, a_idx, pos, 0)
        sel = scatter_fill(inv_len, a_idx, torch.ones_like(mask[:k]),
                           False)
    return Partition(order, overflow, tuple(r[order] for r in rows), rank,
                     a_idx, inv, sel)


def stitch_survivors(order: torch.Tensor, tms: Sequence[dict],
                     segs: Sequence[dict], keep: torch.Tensor,
                     slot_rank: Optional[torch.Tensor]):
    """The survivor rows of a launch's time-major segment buffers.

    order [k]: survivor slots on the launch's m axis; tms: per segment a
    dict of time-major [T_s, w_s] buffers (TRACK_FIELDS, 'alive'; winds
    [T_s, w_s, W]); segs: per later segment its {'inv', 'selected'} [m]
    maps.  Each survivor's row continues with its column in every later
    segment it rode; a storm absent from a segment reads its column 0,
    masked dead.  Returns ({field: [k, T] (winds [k, T, W]) NaN where not
    alive}, keep_full): keep [m] put back on the [n] slot axis through the
    integrate compaction's slot_rank (keep itself when there was none)."""
    if order.device.type == 'cpu':
        return stitch_survivors_plain(order, tms, segs, keep, slot_rank)
    from tropical_cyclone_risk_tpu_torch.kernels import compact as k4
    return k4.stitch_cuda(order, tuple(tms), tuple(segs), keep, slot_rank)


def stitch_survivors_plain(order, tms, segs, keep, slot_rank):
    """Plain twin of ``stitch_survivors``."""
    if order.is_cuda:
        kernels.PLAIN_ON_CUDA['compact'] += 1
    # pick survivor columns of the time-major buffers, then put time second
    gt = lambda a, b: a[:, b].transpose(0, 1)
    cols = [order] + [seg['inv'][order] for seg in segs]
    alive = torch.cat([gt(tms[0]['alive'], order)] + [
        seg['selected'][order][:, None] & gt(tm['alive'], c)
        for tm, seg, c in zip(tms[1:], segs, cols[1:])], dim=1)
    tracks = {}
    for f in TRACK_FIELDS:
        x = torch.cat([gt(tm[f], c) for tm, c in zip(tms, cols)], dim=1)
        a = alive if x.dim() == alive.dim() else alive[..., None]
        tracks[f] = torch.where(a, x, math.nan)
    if slot_rank is None:
        return tracks, keep
    keep_full = (slot_rank >= 0) & keep[torch.clamp_min(slot_rank, 0)]
    return tracks, keep_full
