"""The readers of the program's own spans (tcbench/metrics/driver.*,
launch.span_host_ms, fields.span_stacks_ms) on a hand-built Trace: each
returns the value worked out by hand below, and None where the trace
holds no tc.launch span (a program without spans)."""

from types import SimpleNamespace

import pytest

from tcbench import run as run_mod
from tcbench.trace import Trace

# times in microseconds.  The card runs three kernels, busy over [100, 150],
# [300, 400] and [600, 640] of the window [0, 1000]: idle 100 + 150 + 200 +
# 360 = 810.  Two launches, each with a stacks span; kernels 1 and 3 are
# launched inside the stacks spans (50 + 40 of device time), kernel 2
# outside them.
DEVICE = [('cat_a', 'kernel', 100.0, 50.0, 1),
          ('integrate', 'kernel', 300.0, 100.0, 2),
          ('cat_b', 'kernel', 600.0, 40.0, 3)]
LAUNCH_AT = {1: 20.0, 2: 250.0, 3: 520.0}
RANGES = {
    'tcbench.window': [(0.0, 1000.0)],
    'tc.launch': [(0.0, 280.0), (500.0, 780.0)],
    'tc.launch.stacks': [(10.0, 30.0), (510.0, 530.0)],
    # over idle time: 60 of [160, 220], 50 of [380, 450] (the card busy
    # until 400), 80 of [900, 980]; 210 of copying in all
    'tc.driver.copy': [(160.0, 220.0), (380.0, 450.0), (900.0, 980.0)],
    'tc.driver.wait': [(280.0, 300.0), (780.0, 800.0), (800.0, 810.0)],
    'tc.driver.uncapped_relaunch': [(450.0, 800.0)],
}
YEARS = 2

EXPECTED = {
    'driver.copy_ms': 210.0 / YEARS * 1e-3,
    'driver.wait_ms': 50.0 / YEARS * 1e-3,
    'driver.copy_idle_share': 100.0 * 190.0 / 810.0,
    'driver.blocking_reads_per_year': 3 / YEARS,
    'driver.relaunches_per_year': 1 / YEARS,
    'launch.span_host_ms': 280.0 * 1e-3,
    'fields.span_stacks_ms': (50.0 + 40.0) / 2 * 1e-3,
}


def _rec(ranges):
    host = [(name, s, e) for name, rs in ranges.items() for s, e in rs]
    tr = Trace((0.0, 1000.0), DEVICE, LAUNCH_AT, ranges, host)
    return SimpleNamespace(trace=tr, traced_years=YEARS)


@pytest.mark.parametrize('metric', sorted(EXPECTED))
def test_span_metric_reads_hand_value(metric):
    assert run_mod.reader(metric)(_rec(RANGES)) == pytest.approx(
        EXPECTED[metric], rel=1e-12)


@pytest.mark.parametrize('metric', sorted(EXPECTED))
def test_span_metric_none_without_program_spans(metric):
    ranges = {k: v for k, v in RANGES.items() if k != 'tc.launch'}
    assert run_mod.reader(metric)(_rec(ranges)) is None
    assert run_mod.reader(metric)(SimpleNamespace(
        trace=None, traced_years=YEARS)) is None


def test_span_metrics_in_benchmark():
    """Each reader is a per-layer metric of every cell's traced run."""
    for cell in run_mod.load_json('..', 'BENCHMARK.json')['workloads']:
        names = [n for n, _ in run_mod.cell_metrics(cell['name'], True)]
        assert set(EXPECTED) <= set(names)
