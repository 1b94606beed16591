"""The port's spans (utils/obs.py span): the year driver's and the launch's
profiler ranges in a torch.profiler trace of the fused driver, and what a
span is with no profiler running.  Sizes of tests/test_torch_years.py:
synthetic 91x180 packs, 2048 seeds per launch, two years, k_fuse=2.
"""

import contextlib
from collections import Counter
from typing import NamedTuple

import pytest
import torch

from tropical_cyclone_risk_tpu_torch import rng
from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.models import fields, pipeline
from tropical_cyclone_risk_tpu_torch.utils import obs

SEG = dict(integrate_cap=0.375, recompact_schedule=((90, 0.75), (180, 0.5)))
STAGES = ('propose', 'partition', 'draw', 'stacks', 'gate', 'vmax',
          'compact')
RELAUNCHES = ('tc.driver.prefix_relaunch', 'tc.driver.uncapped_relaunch')

# case -> (namelist fields, pack planes, key): the steady state settles
# every year on its fused batch 0 (a launch of two segments);
# the fallback's batch 0 overflows its compaction cap in every year
CASES = {
    'steady': (dict(seed_batch=2048, end_year=2017, end_month=6,
                    tracks_per_year=5, **SEG), 18, 42),
    'fallback': (dict(seed_batch=2048, end_year=2017, tracks_per_year=4,
                      integrate_cap=1.0 / 16.0), 24, 7),
}


class Range(NamedTuple):
    name: str
    start: int
    end: int


@contextlib.contextmanager
def user_ranges(out: list):
    """torch.profiler's CPU profiler recording user ranges alone
    (record_function's scope), the Ranges appended to ``out`` on exit.  A
    full trace would also record every aten op of the CPU twins, about a
    million at these sizes, and take minutes to collect."""
    from torch._C._profiler import (ProfilerActivity, ProfilerConfig,
                                    ProfilerState, RecordScope,
                                    _ExperimentalConfig)
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                         False, _ExperimentalConfig())
    acts = {ProfilerActivity.CPU}
    torch.autograd._prepare_profiler(cfg, acts)
    torch.autograd._enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    try:
        yield
    finally:
        res = torch.autograd._disable_profiler()
        out.extend(Range(e.name(), e.start_ns(),
                         e.start_ns() + e.duration_ns())
                   for e in res.events())


def _inside(r, outer) -> bool:
    return any(o.start <= r.start and r.end <= o.end for o in outer)


def _overlap(a, b) -> bool:
    return a.start < b.end and b.start < a.end


@pytest.mark.parametrize('case', sorted(CASES))
def test_fused_driver_spans(case, monkeypatch):
    """Per year one tc.launch holding each stage span (a tc.launch.segment
    per segment), one tc.driver.wait per group read, copies beside the
    waits and never over them; no relaunch or fallback in the steady
    state, whose years are views of the group's read (no copy), and in
    the fallback one tc.driver.fallback a year with at least one uncapped
    relaunch, and one wait for the group's read, one per later launch and
    one per seed count read up to a year's last track; a host transfer
    (tc.driver.transfer) inside a dispatch for the group and for each
    later launch."""
    kw, n_planes, seed = CASES[case]
    cfg = Namelist().replace(**kw)
    pack = fields.synthetic_pack(cfg, n_planes, 91, 180, seed=0,
                                 device='cpu')
    years = list(cfg.years())
    # every launch counts its seeds up to its last row once
    # (compact_survivors); a call beyond those is the driver's host read
    counts = []
    orig = pipeline._count_upto_body
    monkeypatch.setattr(pipeline, '_count_upto_body',
                        lambda *a: (counts.append(a[4]), orig(*a))[1])
    evs = []
    with user_ranges(evs):
        assert obs.span('tc.launch') is not obs.span('tc.launch')
        out = pipeline.run_tracks_years_fused(rng.key(seed), pack, cfg,
                                              'GL', years, k_fuse=2)
    assert [y.lon.shape[0] for y in out] == [cfg.tracks_per_year] * 2
    assert evs and all(e.name.startswith('tc.') for e in evs)
    n = Counter(e.name for e in evs)
    by = lambda name: [e for e in evs if e.name == name]

    launches = by('tc.launch')
    for e in evs:
        if e.name.startswith('tc.launch.'):
            assert _inside(e, launches), e.name
    # a wait and a copy never nest in each other, so their times add up
    for w in by('tc.driver.wait'):
        assert not any(_overlap(w, c) for c in by('tc.driver.copy'))
    assert n['tc.driver.dispatch'] >= 1
    # a host transfer is issued inside the dispatch of the work it reads
    assert n['tc.driver.transfer'] >= 1
    for t in by('tc.driver.transfer'):
        assert _inside(t, by('tc.driver.dispatch'))

    if case == 'steady':
        n_seg = 1 + len(pipeline.seg_schedule(
            cfg, pipeline.launch_width(cfg, cfg.seed_batch)))
        assert n_seg >= 2
        assert n['tc.launch'] == len(years)
        for stage in STAGES:
            assert n[f'tc.launch.{stage}'] == len(years), stage
        assert n['tc.launch.segment'] == n_seg * len(years)
        # one group of two years: one read, one issue, and no copy: the
        # settled years are views of the group's read
        assert n['tc.driver.wait'] == 1
        assert n['tc.driver.copy'] == 0
        assert n['tc.driver.dispatch'] == 1
        assert n['tc.driver.transfer'] == 1
        for name in RELAUNCHES + ('tc.driver.fallback',):
            assert n[name] == 0, name
    else:
        assert n['tc.driver.fallback'] == len(years)
        assert n['tc.driver.uncapped_relaunch'] >= 1
        # each relaunch holds its own launch and read
        for name in RELAUNCHES:
            for r in by(name):
                assert any(_inside(x, [r]) for x in launches)
                assert any(_inside(x, [r]) for x in by('tc.driver.wait'))
        # the group's read, then each fallback year's reads of its later
        # batches (its batch 0 is the group's read) and of its seed counts
        n_upto = len(counts) - n['tc.launch']
        assert n['tc.driver.wait'] == 1 + n['tc.launch'] - len(years) + n_upto
        # the group's transfer, then one behind each later launch
        assert n['tc.driver.transfer'] == 1 + n['tc.launch'] - len(years)
        assert n['tc.launch'] >= 2 * len(years)


@pytest.mark.parametrize('name', ['tc.launch', 'tc.driver.wait', 'other'])
def test_span_without_profiler_is_shared_null_context(name):
    assert not torch.autograd._profiler_enabled()
    s = obs.span(name)
    assert isinstance(s, contextlib.nullcontext)
    assert s is obs.span('tc.launch.stacks')
    with s:
        pass
