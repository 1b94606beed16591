"""The port's bench entry point (tropical_cyclone_risk_tpu_torch.bench) at a
tiny size on the CPU: one JSON line with the keys of the JAX package's
bench.py line, positive rates; without a GPU it raises unless the CPU is
asked for."""

import ast
import json
from pathlib import Path

import pytest
import torch

from tropical_cyclone_risk_tpu_torch import bench

ROOT = Path(__file__).resolve().parents[1]
TINY = ['--device', 'cpu', '--seeds', '1024', '--nlat', '46', '--nlon',
        '90', '--years', '2', '--iters', '2', '--reps', '1',
        '--tracks-per-year', '4']


def _bench_py_keys():
    """(top-level keys, detail keys) of the dict bench.py prints."""
    tree = ast.parse((ROOT / 'bench.py').read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == 'detail'
                for k in node.keys):
            detail = node.values[[k.value for k in node.keys].index('detail')]
            return ({k.value for k in node.keys},
                    {k.value for k in detail.keys})
    raise AssertionError('no JSON dict in bench.py')


def test_bench_prints_one_json_line(capsys):
    assert bench.main(TINY) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    top, detail = _bench_py_keys()
    assert set(out) == top and set(out['detail']) == detail
    d = out['detail']
    assert out['vs_baseline'] is None
    assert (d['platform'], d['device'], d['n_seeds_per_launch']) == (
        'cpu', 'cpu', 1024)
    for v in (out['value'], d['scan_rows_per_min'],
              d['surviving_tcs_per_min'], d['sim_years_per_min'],
              d['seconds_per_sim_year'],
              d['seconds_per_sim_year_unfused_loop'], d['launch_seconds']):
        assert v > 0
    assert 'TPU' not in d['units_note']


def test_bench_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='--device cpu'):
        bench.main([])
