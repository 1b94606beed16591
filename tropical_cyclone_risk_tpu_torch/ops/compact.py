"""Slot-stable compaction order (twin of
tropical_cyclone_risk_tpu/ops/compact.py): one prefix sum and one scatter
give the permutation ``argsort(where(mask, slot, slot + n))``, bit for bit.
"""

from __future__ import annotations

import torch


def stable_partition_order(mask: torch.Tensor, w: int | None = None):
    """[n] bool -> int64 order with the True slots first, each class in
    ascending slot order, truncated to the first ``w`` entries."""
    n = mask.shape[0]
    c = torch.cumsum(mask.to(torch.int64), 0)              # inclusive count
    slot = torch.arange(n, dtype=torch.int64, device=mask.device)
    rank = torch.where(mask, c - 1, c[-1] + slot - c)     # a permutation
    order = torch.empty_like(slot).index_put_((rank,), slot)
    return order if w is None or w >= n else order[:w]
