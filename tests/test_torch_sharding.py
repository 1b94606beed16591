"""The port's seed-axis sharding (parallel.sharding and the mesh path of
the year drivers) against the JAX package's on the same mesh: the port's 8
virtual CPU shards, the JAX package's 8 host devices (tests/conftest.py).
Sizes are tests/test_sharding.py's: 256-12288 seeds on synthetic 91x180
packs.

Tolerances, with their reasons:
- one sharded launch, port against JAX: the per-slot metadata (keep,
  counted, month, basin_idx), the overflow pairs, the scalars, the seed
  tables (spm_upto, spm_all) and the survivors' valid, month and basin_idx
  equal bit for bit; the survivor tracks NaN where JAX's are NaN and
  within tests/test_torch_pipeline.py's TRACK_TOL elsewhere (XLA on the CPU
  contracts multiply-adds and rounds transcendentals otherwise than torch);
  k_max covers every survivor, so rows of every shard are stitched;
- the year drivers on the mesh, port against JAX: seeds_per_month, months,
  basins, track counts, n_dropped and n_proposed equal, tracks within
  TRACK_TOL;
- the port against itself (the fused driver against the per-year loop,
  the quota prefix against the full width): every field bit for bit, as
  tests/test_torch_years.py holds them on one device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu.config import Namelist as JNamelist
from tropical_cyclone_risk_tpu.models import fields as jfields
from tropical_cyclone_risk_tpu.models import pipeline as jpipeline
from tropical_cyclone_risk_tpu.parallel import sharding as jsharding
from tropical_cyclone_risk_tpu_torch import cli, rng
from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.models import fields, pipeline
from tropical_cyclone_risk_tpu_torch.parallel import sharding
from test_torch_pipeline import TRACK_KEYS, TRACK_TOL

N_DEV = 8
META_EXACT = ('keep', 'counted', 'month', 'basin_idx', 'overflow', 'scalars',
              'spm_upto', 'spm_all')
# name: (seeds, namelist fields); k_max min(n / 2, 512) holds every survivor
LAUNCHES = {
    'one_segment': (256, {}),
    'capped': (4096, dict(integrate_cap=0.5)),
    'two_segment': (8192, dict(integrate_cap=0.5, recompact_step=120,
                               recompact_cap=0.5)),
    'multi_segment': (12288, dict(integrate_cap=0.5, recompact_schedule=(
        (90, 0.6), (200, 0.33)))),
}


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op torch thread for the module: a mesh launch issues each
    shard's small ops in turn (32-1536 seeds a shard), where more threads
    cost more than they save (a 4096-seed launch on 8 shards took 12.6 s
    at eight threads and 9.7 s at one on an 8-core CPU); the port's
    results are the same at any count."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def packs():
    jpack = jfields.synthetic_pack(JNamelist(), 12, 91, 180, seed=0)
    return jpack, fields.pack_from_numpy(jpack, device='cpu')


@pytest.fixture(scope='module')
def meshes():
    return jsharding.make_mesh(N_DEV), sharding.make_mesh(N_DEV, 'cpu')


def _launches(packs, meshes, n, kw, seed=3):
    k_max = min(n // 2, 512)
    jm, pm = meshes
    jt, jmeta = jsharding.simulate_batch_sharded(
        jm, jax.random.key(seed), jsharding.replicate_pack(packs[0], jm),
        JNamelist(seed_batch=n, **kw), 'GL', n=n, k_max=k_max,
        plane_offset=jnp.int32(0))
    pt, pmeta = sharding.simulate_batch_sharded(
        pm, rng.key(seed), sharding.replicate_pack(packs[1], pm),
        Namelist(seed_batch=n, **kw), 'GL', n, k_max, 0)
    return (_np(pt), _np(pmeta)), (_np(jt), _np(jmeta))


@pytest.fixture(scope='module')
def one_segment(packs, meshes):
    n, kw = LAUNCHES['one_segment']
    return _launches(packs, meshes, n, kw)


def _assert_tracks_close(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b),
                                  err_msg=name)
    fin = np.isfinite(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=TRACK_TOL[name],
                               err_msg=name)


def _assert_sharded_match(port, jax_out):
    (pt, pm), (jt, jm) = port, jax_out
    for k in META_EXACT:
        np.testing.assert_array_equal(pm[k].astype(np.int64),
                                      jm[k].astype(np.int64), err_msg=k)
    for k in ('valid', 'month', 'basin_idx'):
        np.testing.assert_array_equal(pt[k].astype(np.int64),
                                      jt[k].astype(np.int64), err_msg=k)
    n_surv = int(pm['scalars'][0])
    assert 0 < n_surv <= pt['valid'].shape[0]
    for k in TRACK_KEYS:
        _assert_tracks_close(pt[k], jt[k], k)
    return n_surv


@pytest.mark.parametrize('name', list(LAUNCHES))
def test_sharded_launch_matches_jax(packs, meshes, one_segment, name):
    """simulate_batch_sharded on 8 shards against the JAX package's on 8
    devices: unsegmented without and with the integrate compaction (the
    port's slot_rank offset per shard), the two-segment and the
    multi-segment schedule (each later segment's inv offset per shard).
    The shards' survivors all lie in the stitched rows."""
    n, kw = LAUNCHES[name]
    m_local = pipeline.launch_width(Namelist(**kw), n // N_DEV)
    n_seg = {'one_segment': 0, 'capped': 0, 'two_segment': 1,
             'multi_segment': 2}[name]
    assert len(pipeline.seg_schedule(Namelist(**kw), m_local)) == n_seg
    assert (m_local < n // N_DEV) == (name != 'one_segment')
    port, jax_out = (one_segment if name == 'one_segment'
                     else _launches(packs, meshes, n, kw))
    n_surv = _assert_sharded_match(port, jax_out)
    keep = port[1]['keep'].reshape(N_DEV, -1)
    if name != 'one_segment':
        # survivors on several shards, so their rows come from each
        assert (keep.sum(axis=1) > 0).sum() >= 4, keep.sum(axis=1)
        assert n_surv >= 8


def test_shards_draw_different_streams(one_segment):
    """Each shard folds its index into the key: the shards' months
    differ."""
    (_, meta), _ = one_segment
    months = meta['month'].reshape(N_DEV, -1)
    assert not all(np.array_equal(months[0], months[d])
                   for d in range(1, N_DEV))


def test_one_shard_mesh_is_not_the_unsharded_launch(packs):
    """fold_in applies at shard 0 too: a one-shard mesh draws the stream
    of fold_in(key, 0), as the JAX package's does."""
    cfg = Namelist(seed_batch=256)
    mesh = sharding.make_mesh(1, 'cpu')
    _, m1 = sharding.simulate_batch_sharded(mesh, rng.key(3), packs[1], cfg,
                                            'GL', 256, 8, 0)
    _, m0 = pipeline._simulate_batch(rng.fold_in(rng.key(3), 0), packs[1],
                                     cfg, 'GL', 256, 8, 0)
    _, mu = pipeline._simulate_batch(rng.key(3), packs[1], cfg, 'GL', 256,
                                     8, 0)
    for k in ('month', 'counted', 'keep'):
        assert torch.equal(m1[k], m0[k]), k
    assert not torch.equal(m1['month'], mu['month'])


def test_mesh_errors(packs):
    """Fewer cards than asked for name 'devices'; a batch the shards
    cannot split names 'divisible'."""
    with pytest.raises(ValueError, match='devices'):
        sharding.make_mesh(1024)
    mesh = sharding.make_mesh(N_DEV, 'cpu')
    with pytest.raises(ValueError, match='divisible'):
        sharding.simulate_batch_sharded(mesh, rng.key(0), packs[1],
                                        Namelist(seed_batch=255), 'GL', 255,
                                        4, 0)
    assert len(mesh.devices) == mesh.size == N_DEV and mesh.first == 0
    assert sharding.SEED_AXIS == jsharding.SEED_AXIS


def test_cli_devices(monkeypatch):
    """cli --devices N builds the mesh before any preprocessing: with too
    few cards it is make_mesh's 'devices' error (not NotImplementedError)."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(ValueError, match='devices'):
        cli.main(['GL', '--devices', '2'])


def _assert_years_close(ours, theirs, n_tracks):
    for t, j in zip(ours, theirs):
        np.testing.assert_array_equal(t.n_seeds, j.n_seeds)
        for k in ('month', 'basin_idx'):
            np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
        assert (t.n_dropped, t.n_proposed) == (j.n_dropped, j.n_proposed)
        assert t.lon.shape[0] == n_tracks
        for k in TRACK_KEYS:
            _assert_tracks_close(getattr(t, k), getattr(j, k), k)


def _assert_years_equal(ref, got):
    assert len(ref) == len(got)
    for r, f in zip(ref, got):
        for k in pipeline.YEAR_FIELDS + ('n_seeds',):
            a, b = getattr(r, k), getattr(f, k)
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        assert (r.n_dropped, r.n_proposed) == (f.n_dropped, f.n_proposed)


def test_quota_prefix_on_mesh_matches_jax(packs, meshes, monkeypatch):
    """The speculative quota prefix on the mesh (tests/test_sharding.py's
    test_sharded_quota_prefix_identical): the per-shard prefix is sized
    for the full quota (256 slots of 512), scalars[4] settles the year on
    the prefix launch, and the year equals the full-width year bit for bit;
    run_tracks_year on the mesh equals the JAX package's."""
    kw = dict(seed_batch=8192, tracks_per_year=2, integrate_cap=0.5,
              survivors_per_slot=0.5)
    cfg, jcfg = Namelist(**kw), JNamelist(**kw)
    cq = pipeline.quota_cfg(cfg, 2, 8192, N_DEV)
    assert cq is not None and pipeline.launch_width(cq, 1024) == 256
    assert pipeline.quota_cfg(cfg, 2, 8192, N_DEV).integrate_width == \
        jpipeline.quota_cfg(jcfg, 2, 8192, N_DEV).integrate_width
    jm, pm = meshes
    widths = []
    orig = pipeline._dispatch_batch
    monkeypatch.setattr(pipeline, '_dispatch_batch', lambda *a: (
        widths.append(pipeline.launch_width(a[2], a[4] // N_DEV)), orig(*a))[1])
    yq = pipeline.run_tracks_year(rng.key(29), packs[1], cfg, 'GL', 0,
                                  mesh=pm)
    assert widths == [256], 'the prefix launch must settle the year'
    yf = pipeline.run_tracks_year(rng.key(29), packs[1],
                                  cfg.replace(quota_prefix=False), 'GL', 0,
                                  mesh=pm)
    assert widths == [256, 512]
    _assert_years_equal([yf], [yq])
    jq = jpipeline.run_tracks_year(jax.random.key(29),
                                   jsharding.replicate_pack(packs[0], jm),
                                   jcfg, 'GL', 0, mesh=jm)
    _assert_years_close([yq], [jq], 2)


def test_fused_years_on_mesh(meshes):
    """run_tracks_years_fused on the mesh equals the port's per-year loop
    on the mesh bit for bit, and the JAX package's fused driver on its
    mesh (tests/test_sharding.py's test_sharded_fused_years_identical)."""
    kw = dict(seed_batch=4096, tracks_per_year=3, end_year=2017,
              integrate_cap=0.5, recompact_schedule=((120, 0.5),))
    cfg, jcfg = Namelist(**kw), JNamelist(**kw)
    jpack = jfields.synthetic_pack(jcfg, 24, 91, 180, seed=0)
    pack = fields.pack_from_numpy(jpack, device='cpu')
    jm, pm = meshes
    key = rng.key(13)
    years = list(cfg.years())
    ref = [pipeline.run_tracks_year(rng.fold_in(key, yr), pack, cfg, 'GL',
                                    yi, mesh=pm)
           for yi, yr in enumerate(years)]
    fused = pipeline.run_tracks_years_fused(key, pack, cfg, 'GL', years,
                                            k_fuse=2, mesh=pm)
    _assert_years_equal(ref, fused)
    theirs = jpipeline.run_tracks_years_fused(
        jax.random.key(13), jsharding.replicate_pack(jpack, jm), jcfg, 'GL',
        years, k_fuse=2, mesh=jm)
    _assert_years_close(fused, theirs, 3)


def test_simulate_years_sharded():
    """simulate_years_sharded: batch 0 of each year over the mesh, equal
    bit for bit to simulate_batch_sharded on each year's planes with
    run_tracks_year's batch-0 key (a two-shard mesh, two years)."""
    cfg = Namelist(seed_batch=512, end_year=2017)
    pack = fields.synthetic_pack(cfg, 24, 46, 90, seed=0, device='cpu')
    mesh = sharding.make_mesh(2, 'cpu')
    key = rng.key(17)
    iv = [fields.year_plane_indices(cfg, pack.n_planes, yi) for yi in (0, 1)]
    got = sharding.simulate_years_sharded(
        mesh, key, [2016, 2017], [x[0] for x in iv], [x[1] for x in iv],
        pack, cfg, 'GL', 512, 16)
    assert len(got) == 2
    for yi, (year, (tr, meta)) in enumerate(zip((2016, 2017), got)):
        ref = sharding.simulate_batch_sharded(
            mesh, rng.fold_in(rng.fold_in(key, year), 0),
            fields.slice_pack_year(pack, cfg, yi), cfg, 'GL', 512, 16, 0)
        for g, r in zip((tr, meta), ref):
            for k in r:
                np.testing.assert_array_equal(g[k].numpy(), r[k].numpy(),
                                              err_msg=k)
    assert not torch.equal(got[0][1]['month'], got[1][1]['month'])
