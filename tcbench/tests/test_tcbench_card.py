"""One short run of each cell on the card, through the command the
driver runs: it exits 0 and its last line is a correct result."""

import json
import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())


@pytest.mark.card
@pytest.mark.parametrize('cell', [c['name'] for c in BENCH['workloads']])
def test_cell_runs_on_the_card(cuda_card, cell):
    res = subprocess.run(BENCH['command'] + [
        '--workload', cell, '--seed', '3000000001', '--seconds', '2',
        '--trace', '0'], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out['correct'], out['check']
    assert out['device']['platform'] == 'gpu'
