"""Small-matrix Cholesky, unrolled and batched (twin of
tropical_cyclone_risk_tpu/ops/chol.py).

The factorization is unrolled over the tiny static matrix dimension so it is
purely elementwise over the batch; non-positive pivots are reported as a mask
so callers reproduce the reference's zero-winds fallback.
"""

from __future__ import annotations

import torch


def cholesky_unrolled(cov: torch.Tensor):
    """Batched lower Cholesky of [..., n, n].  Returns (L, ok); ok is True
    iff every pivot was strictly positive.  L is garbage where ok is False."""
    n = cov.shape[-1]
    L = [[None] * n for _ in range(n)]
    ok = torch.ones(cov.shape[:-2], dtype=torch.bool, device=cov.device)
    for j in range(n):
        d = cov[..., j, j]
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        ok = ok & (d > 0)
        Ljj = torch.sqrt(torch.clamp_min(d, 1e-30))
        L[j][j] = Ljj
        inv = 1.0 / Ljj
        for i in range(j + 1, n):
            s = cov[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    zero = torch.zeros_like(cov[..., 0, 0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(n)],
                        dim=-1) for i in range(n)]
    return torch.stack(rows, dim=-2), ok


def tri_index(i: int, j: int) -> int:
    """Channel of entry (i, j), j <= i, in the row-major packed lower
    triangle (0,0), (1,0), (1,1), (2,0), ..."""
    return i * (i + 1) // 2 + j


def lower_tri_to_full(tri: torch.Tensor, n: int) -> torch.Tensor:
    """Packed lower-triangle channels [..., n(n+1)/2] -> symmetric
    [..., n, n] (the reference's covariance variable order)."""
    rows = [torch.stack([tri[..., tri_index(max(i, j), min(i, j))]
                         for j in range(n)], dim=-1) for i in range(n)]
    return torch.stack(rows, dim=-2)


def nearest_psd(cov: torch.Tensor, jitter: float = 1e-8) -> torch.Tensor:
    """Symmetric [..., n, n] matrices projected onto the PSD cone by
    clipping their eigenvalues at jitter (the reference's nearestPD,
    util/mat.py:185-223, as a direct spectral projection)."""
    sym = 0.5 * (cov + cov.transpose(-1, -2))
    w, v = torch.linalg.eigh(sym)
    return (v * torch.clamp_min(w, jitter)[..., None, :]) @ v.transpose(-1,
                                                                       -2)
