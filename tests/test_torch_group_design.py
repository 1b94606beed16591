"""K1's and K7's group design for five steering levels and more
(csrc/integrator.cu group_factor and group_flow), emulated in torch on the
CPU and held against the plain twin, ops/chol.py cholesky_unrolled and the
colouring of models/fast.py color_winds_given_f, bit for bit.

The emulation follows the kernel's index math: a group of G lanes per
storm, lane l owning the wind rows l, l + G, ...; the packed covariance
factored in place column by column, right-looking (at column j every lane
takes the pivot, its square root and reciprocal; the owner of row i > j
scales its entry and subtracts L[i][j] L[jj][j] from a[i][jj] for
jj = j + 1 .. i), each column's results written back at the next column,
after the group's barrier; then each row's colouring summed over every
wind in order, the zeros above the diagonal included.  Between two
barriers the lanes run in turn here, which is what the kernel computes
only if no lane reads or writes an entry another lane writes in that
interval: the emulation checks that too.  Its arithmetic is the twin's own
float32 torch operations, so any difference is one of order or indexing:
the tolerance is zero.  The kernels themselves are held against the twins
on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.kernels import integrator
from tropical_cyclone_risk_tpu_torch.models import fast
from tropical_cyclone_risk_tpu_torch.ops import chol

N = 240   # covariances per case


def _tri(i):
    return i * (i + 1) // 2


def emulate_factor(cov, W, G):
    """(packed factor [N, T], ok [N]) of the packed covariances cov as
    group_factor computes them with G lanes per storm."""
    a = cov.clone()
    R = -(-W // G)
    pend = {}
    ok = torch.ones(cov.shape[0], dtype=torch.bool)
    for j in range(W):
        # the barrier, then the last column's values
        for lane in range(G):
            for t in range(R):
                i = lane + t * G
                if j > 0 and j - 1 <= i < W:
                    a[:, _tri(i) + j - 1] = pend[lane, t]
        d = a[:, _tri(j) + j]
        ok = ok & (d > 0)
        Ljj = torch.sqrt(torch.clamp_min(d, 1e-30))
        inv = 1.0 / Ljj
        touched = {}      # entry -> the lanes that read or wrote it
        written = {}      # entry -> the lane that wrote it
        for lane in range(G):
            for t in range(R):
                i = lane + t * G
                if i == j:
                    pend[lane, t] = Ljj
                if j < i < W:
                    lij = a[:, _tri(i) + j] * inv
                    touched.setdefault(_tri(i) + j, set()).add(lane)
                    pend[lane, t] = lij
                    for jj in range(j + 1, i + 1):
                        x = a[:, _tri(jj) + j] * inv
                        e = _tri(i) + jj
                        a[:, e] = a[:, e] - lij * x
                        touched.setdefault(_tri(jj) + j, set()).add(lane)
                        touched.setdefault(e, set()).add(lane)
                        written[e] = lane
        for e, lane in written.items():
            assert touched[e] == {lane}, (j, e, touched[e])
    for lane in range(G):
        for t in range(R):
            i = lane + t * G
            if i == W - 1:
                a[:, _tri(i) + i] = pend[lane, t]
    return a, ok


def emulate_color(fac, mean, fv, ok, W, G):
    """The colored winds [N, W] as group_flow sums them: the owner of row
    r adds L[r][c] F[c] for c = 0 .. r and 0 * F[c] above the
    diagonal."""
    w = torch.empty_like(fv)
    for lane in range(G):
        for r in range(lane, W, G):
            col = fac[:, _tri(r)] * fv[:, 0]
            for c in range(1, W):
                Lrc = fac[:, _tri(r) + c] if c <= r else torch.zeros_like(col)
                col = col + Lrc * fv[:, c]
            w[:, r] = torch.where(ok, mean[:, r] + col, 0.0)
    return w


def _covariances(W, seed):
    """[N, T] packed float32 covariances of wind-like scale: a third
    positive definite, a third of rank W / 2 (pivots at rounding level,
    some of them not positive) and a third symmetric but indefinite."""
    rng = np.random.default_rng(seed)
    n = N // 3
    A = rng.standard_normal((n, W, W)) * 4.0
    pd = A @ A.transpose(0, 2, 1) / W + 0.5 * np.eye(W)
    B = rng.standard_normal((n, W, W // 2)) * 4.0
    low = B @ B.transpose(0, 2, 1) / W
    S = rng.standard_normal((N - 2 * n, W, W)) * 4.0
    ind = 0.5 * (S + S.transpose(0, 2, 1))
    full = np.concatenate([pd, low, ind]).astype(np.float32)
    rows, cols = np.tril_indices(W)
    return torch.from_numpy(full[:, rows, cols].copy())


def _cfg(levels):
    """A namelist of `levels` steering levels between 250 and 850 hPa."""
    lv = tuple(int(x) for x in np.linspace(250, 850, levels))
    return Namelist(steering_levels=lv, steering_coefs=(1.0 / levels,) * levels,
                    y_alpha=(1.0 / levels,) * levels, m_alpha=(0.0,) * levels,
                    alpha_max=(0.9,) * levels, alpha_min=(0.0,) * levels)


@pytest.mark.parametrize('levels', [5, 7, 17])
@pytest.mark.parametrize('lanes', [None, 4, 32])
def test_group_factor_and_colouring_match_the_twin(levels, lanes):
    """The lane-split Cholesky and colouring equal cholesky_unrolled and
    color_winds_given_f bit for bit, at the unit's lane count
    (group_lanes) and at 4 and 32 lanes: several rows a lane, and at 17
    levels (34 winds) more rows than 32 lanes."""
    W = 2 * levels
    G = integrator.group_lanes(levels) if lanes is None else lanes
    cov = _covariances(W, seed=levels)
    rng = np.random.default_rng(100 + levels)
    mean = torch.from_numpy(rng.standard_normal((N, W)).astype(np.float32))
    fv = torch.from_numpy(rng.standard_normal((N, W)).astype(np.float32))

    fac, ok = emulate_factor(cov, W, G)
    L, ok_ref = chol.cholesky_unrolled(chol.lower_tri_to_full(cov, W))
    rows, cols = np.tril_indices(W)
    torch.testing.assert_close(fac, L[:, rows, cols], rtol=0, atol=0,
                               equal_nan=True)
    assert torch.equal(ok, ok_ref)
    assert 0 < int(ok.sum()) < N      # positive definite and not

    w = emulate_color(fac, mean, fv, ok, W, G)
    ref = fast.color_winds_given_f(_cfg(levels), torch.cat([mean, cov], 1),
                                   fv)
    torch.testing.assert_close(w, ref, rtol=0, atol=0, equal_nan=True)
