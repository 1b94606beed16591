"""Every configuration, traffic mix, cell and metric file loads by its
name, and the names, units and cross references of BENCHMARK.json keep to
the benchmark's rules."""

import importlib.util
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
METRICS = BENCH['end_to_end'] + BENCH['per_layer']


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024


@pytest.mark.parametrize('cfg', BENCH['configs'], ids=lambda c: c['name'])
def test_config_file(cfg):
    assert NAME.match(cfg['name'])
    data = json.loads((ROOT / cfg['file']).read_text())
    assert data['name'] == cfg['name']
    assert data['source'] == cfg['source']
    assert data['reduced'] == cfg['reduced']
    levels = data['namelist']['steering_levels']
    assert 250 in levels and 850 in levels
    for key in ('steering_coefs', 'y_alpha', 'm_alpha', 'alpha_max',
                'alpha_min'):
        assert len(data['namelist'][key]) == len(levels)


@pytest.mark.parametrize('cell', BENCH['workloads'], ids=lambda c: c['name'])
def test_cell_files(cell):
    from tcbench import run as run_mod
    assert NAME.match(cell['name']) and NAME.match(cell['traffic'])
    assert len(cell['why']) <= 200 and cell['chips'] == 1
    loaded = run_mod.load_cell(cell['name'])
    assert loaded['cell']['config'] == cell['config']
    assert loaded['cell']['traffic'] == cell['traffic']
    assert loaded['cell']['why'] == cell['why']
    assert set(loaded['cell']['check']['limits']) == {
        'track_gap', 'count_gap', 'seed_count_gap'}
    assert loaded['cell']['check']['limits']['count_gap'] == 0.0
    for trace in (False, True):
        names = [n for n, _ in run_mod.cell_metrics(cell['name'], trace)]
        assert names, (cell['name'], trace)
    assert 'setup_s' in [n for n, _ in run_mod.cell_metrics(cell['name'],
                                                            False)]


@pytest.mark.parametrize('metric', METRICS, ids=lambda m: m['name'])
def test_metric_reader(metric):
    assert NAME.match(metric['name']) and UNIT.match(metric['unit'])
    assert metric['better'] in ('lower', 'higher')
    path = ROOT / 'tcbench' / 'metrics' / f"{metric['name']}.py"
    spec = importlib.util.spec_from_file_location('m', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)
    cells = {c['name'] for c in BENCH['workloads']}
    assert set(metric.get('workloads', cells)) <= cells


def test_names_unique():
    for group in ('configs', 'workloads'):
        names = [x['name'] for x in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m['name'] for m in METRICS]
    assert len(names) == len(set(names))
    pairs = [(c['config'], c['traffic']) for c in BENCH['workloads']]
    assert len(pairs) == len(set(pairs))


def test_per_layer_moves_an_end_to_end_metric():
    e2e = {m['name'] for m in BENCH['end_to_end']}
    for m in BENCH['per_layer']:
        assert m['moves'] in e2e and m['layer'] and '\n' not in m['layer']
