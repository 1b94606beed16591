"""The launch's compactions (K4's plain twins, ops/compact.py) against the
JAX package: the stable partition order with its row takes, overflow and
composed maps, bit for bit, and the survivor stitch against a direct
numpy construction of compact_survivors' semantics.  K4 itself runs only
on the card (chip_smoke.py holds it against these twins, bit for bit);
here its wrappers must refuse CPU tensors.  Inputs from numpy seeds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu.ops import compact as jcompact
from tropical_cyclone_risk_tpu_torch import kernels
from tropical_cyclone_risk_tpu_torch.kernels import compact as k4
from tropical_cyclone_risk_tpu_torch.ops import compact

FIELDS = compact.TRACK_FIELDS


def _rows(r, n):
    """Row tensors of the launch's dtypes: float32 [n], int64 [n] (in
    int32 range: JAX runs without x64), int32 [n], bool [n] and a Fourier
    row [n, 4, 15]."""
    return (r.standard_normal(n).astype(np.float32),
            r.integers(0, 1 << 31, n),
            r.integers(1, 13, n).astype(np.int32),
            r.random(n) < 0.5,
            r.standard_normal((n, 4, 15)).astype(np.float32))


def _w(case, count, n):
    return {'below': max(count - 7, 0), 'at': count,
            'above': min(count + 5, n), 'ge_n': n + 3}[case]


@pytest.mark.parametrize('w_case', ['below', 'at', 'above', 'ge_n'])
@pytest.mark.parametrize('density', [0.0, 0.3, 1.0])
@pytest.mark.parametrize('n', [1, 255, 1024, 4097])
def test_partition_take_bit_exact(n, density, w_case):
    """Order, gathered rows, overflow, slot ranks and the composed maps
    against JAX stable_partition_order + jnp.take / .at[].set."""
    r = np.random.default_rng(n * 10 + int(density * 10))
    mask = r.random(n) < density
    count = int(mask.sum())
    w = _w(w_case, count, n)
    rows = _rows(r, n)
    L = n + 7                                 # the outer (m) axis
    a_prev = r.permutation(L)[:n].astype(np.int64)
    acc = np.array([3], np.int64)
    kernels.reset_counts()
    part = compact.partition_take(
        torch.from_numpy(mask), w, tuple(map(torch.from_numpy, rows)),
        acc=torch.from_numpy(acc), slot_rank=True,
        a_prev=torch.from_numpy(a_prev), inv_len=L)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.NAMES, 0)
    assert kernels.PLAIN_ON_CUDA == dict.fromkeys(kernels.NAMES, 0)

    k = min(w, n)

    @functools.partial(jax.jit, static_argnums=(1,))
    def ref(mask, w, rows, a_prev):
        """One program per case (keeps the XLA compiles per file few)."""
        order = jcompact.stable_partition_order(mask, w)
        pos = jnp.arange(k, dtype=jnp.int32)
        a_idx = a_prev[order]
        return (order, tuple(jnp.take(x, order, axis=0) for x in rows),
                jnp.full((n,), -1, jnp.int32).at[order].set(pos), a_idx,
                jnp.zeros((L,), jnp.int32).at[a_idx].set(pos),
                jnp.zeros((L,), bool).at[a_idx].set(True))

    order, taken, rank, a_idx, inv, sel = jax.tree_util.tree_map(
        np.asarray, ref(jnp.asarray(mask), w, tuple(map(jnp.asarray, rows)),
                        jnp.asarray(a_prev.astype(np.int32))))
    assert order.shape == (k,) and part.order.dtype == torch.int64
    np.testing.assert_array_equal(part.order.numpy(), order)
    for got, x, want in zip(part.rows, rows, taken):
        assert got.dtype == torch.from_numpy(x).dtype
        np.testing.assert_array_equal(got.numpy(), want.astype(x.dtype))
    np.testing.assert_array_equal(part.overflow.numpy(),
                                  acc + max(count - w, 0))
    np.testing.assert_array_equal(part.slot_rank.numpy(), rank)
    np.testing.assert_array_equal(part.a_idx.numpy(), a_idx)
    np.testing.assert_array_equal(part.inv.numpy(), inv)
    np.testing.assert_array_equal(part.selected.numpy(), sel)


def _segments(r, m, edges, widths):
    """Time-major segment buffers and their maps as a launch makes them:
    each boundary keeps the alive storms of the previous segment first."""
    tms, segs, a_idx, alive = [], [], None, r.random(m) < 0.8
    for s, w in enumerate(widths):
        if s > 0:
            part = compact.partition_take_plain(
                torch.from_numpy(alive), w, a_prev=a_idx, inv_len=m)
            a_idx = part.a_idx
            segs.append({'inv': part.inv, 'selected': part.selected})
            alive = alive[part.order.numpy()]
        T_s = edges[s + 1] - edges[s]
        # each storm dies at a random step of the segment, or lives on
        death = r.integers(0, 2 * T_s, w)
        al = (np.arange(T_s)[:, None] < death[None]) & alive[None]
        tm = {f: torch.from_numpy(r.standard_normal((T_s, w)).astype(
            np.float32)) for f in FIELDS[:-1]}
        tm['wnds'] = torch.from_numpy(
            r.standard_normal((T_s, w, 4)).astype(np.float32))
        tm['alive'] = torch.from_numpy(al)
        tms.append(tm)
        alive = al[-1]
    return tms, segs


def _stitch_numpy(order, tms, segs, edges):
    """compact_survivors' stitch, one survivor and step at a time."""
    k, T = len(order), edges[-1]
    out = {f: np.full((k, T), np.nan, np.float32) for f in FIELDS[:-1]}
    out['wnds'] = np.full((k, T, 4), np.nan, np.float32)
    for j, slot in enumerate(order):
        for s, tm in enumerate(tms):
            col, on = slot, True
            if s > 0:
                col = int(segs[s - 1]['inv'][slot])
                on = bool(segs[s - 1]['selected'][slot])
            for t in range(edges[s], edges[s + 1]):
                if on and bool(tm['alive'][t - edges[s], col]):
                    for f in FIELDS:
                        out[f][j, t] = tm[f][t - edges[s], col].numpy()
    return out


@pytest.mark.parametrize('k_max', [5, 96])
def test_stitch_survivors_twin(k_max):
    """Three segments (96 -> 64 -> 32 storms over 9 + 7 + 6 steps) and a
    keep mask on an integrate-compacted axis: tracks NaN-masked where not
    alive (absent storms read column 0, masked dead), keep back on the
    slot axis through slot_rank."""
    r = np.random.default_rng(7)
    m, n, edges, widths = 96, 150, [0, 9, 16, 22], [96, 64, 32]
    tms, segs = _segments(r, m, edges, widths)
    keep = torch.from_numpy(r.random(m) < 0.3)
    integrate = torch.from_numpy(r.random(n) < 0.7)
    slot_rank = compact.partition_take_plain(integrate, m,
                                             slot_rank=True).slot_rank
    part = compact.partition_take(keep, k_max, (keep,))
    tracks, keep_full = compact.stitch_survivors(part.order, tms, segs, keep,
                                                 slot_rank)
    want = _stitch_numpy(part.order.numpy(), tms, segs, edges)
    assert list(tracks) == list(FIELDS)
    for f in FIELDS:
        np.testing.assert_array_equal(tracks[f].numpy(), want[f], err_msg=f)
    order_int = compact.stable_partition_order(integrate, m).numpy()
    full = np.zeros(n, bool)
    full[order_int] = keep.numpy()
    np.testing.assert_array_equal(keep_full.numpy(), full)
    assert part.rows[0].numpy().sum() == min(k_max, int(keep.sum()))
    tr0, keep0 = compact.stitch_survivors(part.order, tms[:1], (), keep,
                                          None)
    assert keep0 is keep
    np.testing.assert_array_equal(tr0['lon'].numpy(),
                                  tracks['lon'][:, :edges[1]].numpy())


def test_compact_wrappers_refuse_cpu_tensors():
    mask = torch.ones(8, dtype=torch.bool)
    kernels.reset_counts()
    with pytest.raises(ValueError, match='CUDA'):
        k4.partition_cuda(mask, 4, (torch.zeros(8),), slot_rank=True)
    tm = {f: torch.zeros(3, 8) for f in FIELDS[:-1]}
    tm.update(wnds=torch.zeros(3, 8, 4),
              alive=torch.ones(3, 8, dtype=torch.bool))
    with pytest.raises(ValueError, match='CUDA'):
        k4.stitch_cuda(torch.arange(4), (tm,), (), mask, None)
    assert kernels.LAUNCHES['compact'] == 0
    assert kernels.PLAIN_ON_CUDA['compact'] == 0
