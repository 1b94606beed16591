"""The reader of driver.copies_per_year (the port's tc.driver.copy spans
per traced year) on the hand-built trace of test_tcbench_span_metrics:
three copy spans over two years, None where the program has no spans."""

from types import SimpleNamespace

import pytest

from tcbench import run as run_mod
from test_tcbench_span_metrics import RANGES, YEARS, _rec

METRIC = 'driver.copies_per_year'


def test_copies_per_year_reads_hand_value():
    assert run_mod.reader(METRIC)(_rec(RANGES)) == pytest.approx(
        3 / YEARS, rel=1e-12)


def test_copies_per_year_zero_without_copies():
    """Every year handed out as views of its transfer: no copy span."""
    ranges = {k: v for k, v in RANGES.items() if k != 'tc.driver.copy'}
    assert run_mod.reader(METRIC)(_rec(ranges)) == 0.0


def test_copies_per_year_none_without_program_spans():
    ranges = {k: v for k, v in RANGES.items() if k != 'tc.launch'}
    assert run_mod.reader(METRIC)(_rec(ranges)) is None
    assert run_mod.reader(METRIC)(SimpleNamespace(
        trace=None, traced_years=YEARS)) is None


def test_copies_per_year_in_benchmark():
    """A per-layer metric of every cell's traced run."""
    for cell in run_mod.load_json('..', 'BENCHMARK.json')['workloads']:
        names = [n for n, _ in run_mod.cell_metrics(cell['name'], True)]
        assert METRIC in names
