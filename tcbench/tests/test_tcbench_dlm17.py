"""The deep-layer configuration (era5_gl_dlm17: NHC BAMD's 850-200 hPa
layer on ERA5's 17 levels, weights constant in intensity, the uncoupled
track) through the port's plain twins against the reference on the CPU,
at a tiny grid and seed batch, for one member: the same tracks in the
same order and the same seed counts.  The reference computes the coupled
form only; the configuration's zero-slope encoding makes it the constant
weights, so every number is 0."""

from tcbench_tiny import run_cpu, tiny_cell

EXACT = {'track_gap': 0.0, 'count_gap': 0.0, 'seed_count_gap': 0.0}


def test_reference_matches_the_port_at_the_deep_layer():
    cell = tiny_cell('dlm17.landfall', 512, 3, 1, EXACT)
    nl = cell['cfg']['namelist']
    assert nl['coupled_track'] is False and len(nl['steering_levels']) == 17
    out = run_cpu(cell)
    assert out['failed'] == 0
    assert out['correct'], out['check']
    assert {k: v['value'] for k, v in out['check'].items()} == EXACT
