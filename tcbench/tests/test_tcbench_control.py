"""The comparison fails what it must: the control (the reference in
bfloat16 put in the program's place) and the run with the timed path
broken underneath, at a size the CPU holds.  The limits are the cells'
own."""

import contextlib

import numpy as np
import pytest
import torch

from tcbench import calibrate, judge
from tcbench_tiny import run_cpu, tiny_cell

CELLS = ('gl2.landfall', 'gl2.ablation')


@pytest.mark.parametrize('name', CELLS)
def test_control_fails(name):
    cell = tiny_cell(name, 2048, 6, 1)
    res = calibrate.control(cell, 777, 'cpu', log=lambda m: None)
    ok, _ = judge.verdict(res['numbers'], cell['cell']['check']['limits'])
    assert not ok, res


@contextlib.contextmanager
def patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def frozen_step():
    """One RK4 step of the integration (ten hours in) returns its state
    unchanged."""
    from tropical_cyclone_risk_tpu_torch.models import simulator

    def make(orig):
        def step(rhs_fn, t, y, dt):
            y1, w = orig(rhs_fn, t, y, dt)
            return (y, w) if t == 36000.0 else (y1, w)
        return step
    return patched(simulator, '_rk4_step', make)


def half_batch():
    """Half of every seed batch left out: the odd slots never integrate."""
    from tropical_cyclone_risk_tpu_torch.models import seeding

    def make(orig):
        def propose(*a, **kw):
            p = orig(*a, **kw)
            odd = torch.arange(p.integrate.shape[0]) % 2 == 1
            return p._replace(integrate=p.integrate & ~odd)
        return propose
    return patched(seeding, 'propose_seeds', make)


def altered_answer():
    """One delivered track's vmax altered where the year is produced."""
    from tropical_cyclone_risk_tpu_torch.models import pipeline

    def make(orig):
        def years(*a, **kw):
            out = orig(*a, **kw)
            for y in out:
                y.vmax[0, 1] = np.float32(y.vmax[0, 1] + 5.0)
            return out
        return years
    return patched(pipeline, 'run_tracks_years_fused', make)


def extra_track():
    """Every delivered year carries one track more than its quota: its
    last track delivered twice, as an overshoot or rows leaking from
    another year would."""
    from tropical_cyclone_risk_tpu_torch.models import pipeline

    def make(orig):
        def years(*a, **kw):
            out = orig(*a, **kw)
            for y in out:
                for f in ('lon', 'lat', 'v', 'm', 'vmax', 'wnds', 'month',
                          'basin_idx'):
                    x = getattr(y, f)
                    setattr(y, f, np.concatenate([x, x[-1:]]))
            return out
        return years
    return patched(pipeline, 'run_tracks_years_fused', make)


@pytest.mark.parametrize('fault', [frozen_step, half_batch, altered_answer,
                                   extra_track],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize('name', CELLS)
def test_broken_program_is_not_correct(name, fault):
    cell = tiny_cell(name, 1024, 6, 1)
    assert run_cpu(cell)['correct']
    assert not run_cpu(cell, fault=fault())['correct']
