"""Synthetic synoptic wind time series F(t) as an analytic Fourier synthesis
(twin of tropical_cyclone_risk_tpu/ops/fourier.py).

    F_i(t) = sum_n A_in sin(w_n t) + B_in cos(w_n t),    w_n = 2 pi n / T
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from tropical_cyclone_risk_tpu_torch import rng
from tropical_cyclone_risk_tpu_torch.kernels import rng as k5
from tropical_cyclone_risk_tpu_torch.ops import interp

N_FOURIER = 15     # number of sine components (track/bam_track.py:112)


def _omega(T_s: float, device) -> torch.Tensor:
    """w_n = 2 pi n / T in float32, rounded as the JAX package rounds it
    (a true division on every device, see interp.true_div)."""
    n = torch.arange(1, N_FOURIER + 1, dtype=torch.float32, device=device)
    return interp.true_div(2.0 * math.pi * n, float(np.float32(T_s)))


class FourierSeries(NamedTuple):
    A: torch.Tensor     # [..., C, N] sin coefficients
    B: torch.Tensor     # [..., C, N] cos coefficients
    T_s: float          # period (seconds)

    def evaluate(self, t: float) -> torch.Tensor:
        """F(t) -> [..., C] at a scalar time t."""
        phase = _omega(self.T_s, self.A.device) * float(np.float32(t))
        return self.A @ torch.sin(phase) + self.B @ torch.cos(phase)

    def evaluate_in_order(self, t: float) -> torch.Tensor:
        """``evaluate`` with each product summed over the components in
        index order as elementwise adds: the order K1 sums in where it
        evaluates F(t) (rk_exact_stage_fields, rk_substeps > 1), so that the
        kernel is bit for bit the twin there (a matrix product's summation
        order is its library's)."""
        phase = _omega(self.T_s, self.A.device) * float(np.float32(t))
        # the A and B terms side by side: one chain of adds for both sums
        terms = torch.stack((self.A * torch.sin(phase),
                             self.B * torch.cos(phase)))
        acc = terms[..., 0]
        for n in range(1, N_FOURIER):
            acc = acc + terms[..., n]
        return acc[0] + acc[1]

    def evaluate_at_zero(self) -> torch.Tensor:
        """F(0) -> [..., C]: the B components summed in index order, as 14
        elementwise adds.  At t = 0 the A terms of ``evaluate_in_order`` are
        A * 0 = +-0, which change no finite sum, so this is its B chain
        alone, the order K7 adds F(0) in."""
        f0 = self.B[..., 0]
        for n in range(1, N_FOURIER):
            f0 = f0 + self.B[..., n]
        return f0

    def evaluate_grid(self, t: torch.Tensor) -> torch.Tensor:
        """F on a time grid t [T] -> [T, ..., C] as one matrix product over
        the component axis (a plain product outside any kernel)."""
        phase = t[:, None] * _omega(self.T_s, t.device)[None, :]     # [T, f]
        lead = self.A.shape[:-1]
        a = self.A.reshape(-1, N_FOURIER)
        b = self.B.reshape(-1, N_FOURIER)
        out = torch.sin(phase) @ a.T + torch.cos(phase) @ b.T
        return out.reshape((t.shape[0],) + tuple(lead))


def take_leading(fs: FourierSeries, order: torch.Tensor) -> FourierSeries:
    """The coefficient rows at ``order`` [k] of the leading (seed) axis.
    The launch does not call it: K5's row entry draws those rows alone
    (draw_fourier's rows)."""
    return fs._replace(A=fs.A[order], B=fs.B[order])


def amplitudes_formula(device) -> torch.Tensor:
    """[N_FOURIER] amplitudes n^-1.5 with the reference normalization
    sqrt(2 / sum n^-3), evaluated on `device`."""
    n = torch.arange(1, N_FOURIER + 1, dtype=torch.float32, device=device)
    return torch.sqrt(2.0 / torch.sum(n ** -3.0)) * n ** -1.5


@functools.cache
def _amplitudes(device) -> torch.Tensor:
    """amplitudes_formula as the CPU rounds it, on `device`: built on the
    CPU and copied once per device (no copy per launch), so every device
    draws with the CPU's amplitudes; the card's pow and sum round them
    otherwise (by up to 3.7e-9 on an H100)."""
    return amplitudes_formula('cpu').to(device)


def draw_fourier(key: rng.Key, shape, T_s: float, device='cpu',
                 rows=None) -> FourierSeries:
    """Random-phase coefficients (amplitudes as _amplitudes, phases
    uniform in [0, 1) cycles).  shape: batch shape + (C,), e.g.
    (n_seeds, 4).  rows: an int64 [k] tensor of leading indices; the
    result is then the draw of ``shape`` at those rows ([k, C, 15]).  On a
    CUDA device K5's fused entries draw the phases and write A and B
    directly (with rows, at those rows alone); on the CPU the plain twin
    runs."""
    if torch.device(device).type == 'cuda':
        amp = _amplitudes(device)
        A, B = (k5.fourier_cuda(key, shape, amp) if rows is None else
                k5.fourier_rows_cuda(key, shape, rows, amp))
        return FourierSeries(A, B, float(T_s))
    return draw_fourier_plain(key, shape, T_s, device, rows)


def draw_fourier_plain(key: rng.Key, shape, T_s: float, device='cpu',
                       rows=None) -> FourierSeries:
    """Plain twin of ``draw_fourier``: with rows, the full draw gathered
    at them, the JAX package's route (models/pipeline.py launch_inputs)."""
    amp = _amplitudes(device)
    phi = rng.uniform_plain(key, tuple(shape) + (N_FOURIER,), device=device)
    A = amp * torch.cos(2 * math.pi * phi)
    B = amp * torch.sin(2 * math.pi * phi)
    if rows is not None:
        A, B = A[rows], B[rows]
    return FourierSeries(A, B, float(T_s))
