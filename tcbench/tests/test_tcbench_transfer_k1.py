"""The readers of driver.transfer_ms (device time launched inside the
port's tc.driver.transfer spans, per traced year) and launch.k1_ms (K1's
kernels by name, per tc.launch span) on a hand-built trace, None where
the program has neither span; and K1's counted work at the deep layer's
W = 34, by hand."""

from types import SimpleNamespace

import pytest

from tcbench import run as run_mod
from tcbench.roofline import k1
from tcbench.trace import Trace

# times in microseconds.  Two years, three launches; the card runs K1's two
# kernels (the group unit and a segment kernel: 300 + 60), the gate (not
# K1, 40), a cat and a device-to-host copy launched inside the two
# transfer spans (25 + 15 and 30) and a cat outside them (10).
DEVICE = [
    ('void (anonymous namespace)::integrate_group_kernel<17, 0, 0, 0, 0>'
     '(Params<17>)', 'kernel', 100.0, 300.0, 1),
    ('void (anonymous namespace)::genesis_group_kernel<17, 0>(Params<17>)',
     'kernel', 400.0, 40.0, 2),
    ('void integrate_segment_kernel<2, 0, 0, 0, 0>()', 'kernel', 450.0, 60.0,
     3),
    ('CatArrayBatchedCopy', 'kernel', 520.0, 25.0, 4),
    ('Memcpy DtoH (Device -> Pinned)', 'gpu_memcpy', 550.0, 15.0, 5),
    ('CatArrayBatchedCopy', 'kernel', 700.0, 30.0, 6),
    ('CatArrayBatchedCopy', 'kernel', 800.0, 10.0, 7),
]
LAUNCH_AT = {1: 20.0, 2: 30.0, 3: 40.0, 4: 505.0, 5: 510.0, 6: 690.0,
             7: 720.0}
RANGES = {
    'tcbench.window': [(0.0, 1000.0)],
    'tc.launch': [(0.0, 200.0), (200.0, 400.0), (400.0, 500.0)],
    'tc.driver.transfer': [(500.0, 515.0), (680.0, 700.0)],
}
YEARS = 2


def _rec(ranges):
    host = [(name, s, e) for name, rs in ranges.items() for s, e in rs]
    tr = Trace((0.0, 1000.0), DEVICE, LAUNCH_AT, ranges, host)
    return SimpleNamespace(trace=tr, traced_years=YEARS)


EXPECTED = {
    'driver.transfer_ms': (25.0 + 15.0 + 30.0) / YEARS * 1e-3,
    'launch.k1_ms': (300.0 + 60.0) / 3 * 1e-3,
}
# the span whose absence leaves each reader nothing to read
NEEDS = {'driver.transfer_ms': 'tc.driver.transfer',
         'launch.k1_ms': 'tc.launch'}


@pytest.mark.parametrize('metric', sorted(EXPECTED))
def test_reads_hand_value(metric):
    assert run_mod.reader(metric)(_rec(RANGES)) == pytest.approx(
        EXPECTED[metric], rel=1e-12)


@pytest.mark.parametrize('metric', sorted(EXPECTED))
def test_none_without_program_spans(metric):
    ranges = {k: v for k, v in RANGES.items() if k != NEEDS[metric]}
    assert run_mod.reader(metric)(_rec(ranges)) is None
    assert run_mod.reader(metric)(SimpleNamespace(
        trace=None, traced_years=YEARS)) is None


def test_k1_ms_none_without_k1_kernels():
    tr = Trace((0.0, 1000.0), DEVICE[1:2], LAUNCH_AT, RANGES, [])
    assert run_mod.reader('launch.k1_ms')(SimpleNamespace(
        trace=tr, traced_years=YEARS)) is None


@pytest.mark.parametrize('metric', sorted(EXPECTED))
def test_in_every_cell(metric):
    """A per-layer metric of every cell's traced run, none of its
    end-to-end metrics."""
    for cell in run_mod.load_json('..', 'BENCHMARK.json')['workloads']:
        assert metric in [n for n, _ in run_mod.cell_metrics(cell['name'],
                                                             True)]
        assert metric not in [n for n, _ in run_mod.cell_metrics(
            cell['name'], False)]


def test_k1_counts_at_the_deep_layer():
    """W = 34 (17 levels): 34 means + 595 covariance entries + 5 env +
    land + bathy = 636 channels; step: colouring 34*35 = 1190, rhs 4*17 +
    2*34 + 48 = 184 (four: 736), + 56: 1982; gather: blend 6*636 = 3816,
    Cholesky 39304 // 3 = 13101, roots and reciprocals 68, scalings 561:
    17546; step bytes 136 + 16 + 1 + 136 = 289."""
    assert k1.cell_channels(34) == 636
    assert k1.step_flops(34) == 1982
    assert k1.gather_flops(34) == 17546
    assert k1.step_bytes(34) == 289
    assert k1.cell_bytes(34) == 16 * 636
