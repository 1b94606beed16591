"""The reference against the port's plain twins on the CPU, at a tiny
grid and seed batch, for one member of each configuration, and at fifteen
steering levels: the same tracks, in the same order, and the same seed
counts."""

import pytest

from tcbench_tiny import run_cpu, tiny_cell

EXACT = {'track_gap': 0.0, 'count_gap': 0.0, 'seed_count_gap': 0.0}
# fifteen levels (W = 30) with weights made up for this test: the
# reference's steering sums at a width no cell runs yet
LEVELS15 = (250, 300, 350, 400, 450, 500, 550, 600, 650, 700, 750, 775, 800,
            825, 850)


def deep_layer(cell: dict) -> dict:
    nl = cell['cfg']['namelist']
    n = len(LEVELS15)
    spread = [0.5 / (n - 1)] * (n - 1) + [0.5]
    nl.update(steering_levels=list(LEVELS15), steering_coefs=spread,
              y_alpha=list(spread),
              m_alpha=[0.001] + [0.0] * (n - 2) + [-0.001],
              alpha_max=[0.4] * (n - 1) + [0.9],
              alpha_min=[0.05] * (n - 1) + [0.5])
    return cell


@pytest.mark.parametrize('name, seed_batch, quota, n_years, levels', [
    ('gl2.landfall', 2048, 6, 1, 2),    # one launch settles the year
    ('gl2.ablation', 1024, 40, 2, 2),   # the quota needs several batches
    ('gl2.landfall', 512, 2, 1, 15),    # fifteen levels, W = 30
])
def test_reference_matches_the_port(name, seed_batch, quota, n_years,
                                    levels):
    cell = tiny_cell(name, seed_batch, quota, n_years, EXACT)
    if levels == 15:
        cell = deep_layer(cell)
    out = run_cpu(cell)
    assert out['failed'] == 0
    assert out['correct'], out['check']
    assert out['check']['track_gap']['value'] == 0.0
