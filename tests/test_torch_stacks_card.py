"""The field stacks' kernel (csrc/stacks.cu) on a CUDA card: build_stacks'
three outputs equal the plain twin's (models/fields.py build_stacks_plain)
bit for bit at two steering levels (C = 21, land and bathymetry in the
cell row), at the 17-level deep-layer shapes (C = 636, 12 planes), with
land and bathymetry on grids of their own, on a cropped basin, on one
plane and on a gathered year; one build_stacks launches the kernel three
times and nothing else; the wrapper refuses what the kernel does not take.

Imports no JAX, so it runs on a machine with a card, without the JAX
package and without tests/conftest.py:

    python -m pytest tests/test_torch_stacks_card.py --noconftest -q -p no:cacheprovider

Elsewhere it skips (the ``cuda_card`` fixture).
"""

import numpy as np
import pytest
import torch

from tropical_cyclone_risk_tpu_torch import kernels
from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.kernels import stacks as kstacks
from tropical_cyclone_risk_tpu_torch.models import fields
from tropical_cyclone_risk_tpu_torch.ops.interp import UniformGrid

OUTPUTS = ('cell4', 'land_geo4', 'bathy4')


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def _same(pack):
    """build_stacks against the twin on the pack, output by output; the
    kernel's launches counted, the twin's call on CUDA too."""
    kernels.reset_counts()
    got = fields.build_stacks(pack)
    assert kernels.LAUNCHES['stacks'] == 3
    assert kernels.PLAIN_ON_CUDA['stacks'] == 0
    want = fields.build_stacks_plain(pack)
    assert kernels.PLAIN_ON_CUDA['stacks'] == 1
    assert got.geo_in_cell == want.geo_in_cell
    assert got.n_wind_ch == want.n_wind_ch
    for name in OUTPUTS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape and torch.equal(a, b), name
    return got


def _own_grids(pack, fused, dev):
    """The pack with land on 0.5 degrees and bathymetry on that grid
    (fused) or on 0.25 degrees."""
    gen = torch.Generator(device=dev).manual_seed(3)
    land_grid = UniformGrid(0.0, 0.5, 720, -90.0, 0.5, 361)
    bathy_grid = land_grid if fused else UniformGrid(0.0, 0.25, 1440, -90.0,
                                                     0.25, 721)
    field = lambda g: torch.randn((g.nlat, g.nlon), generator=gen,  # noqa
                                  device=dev)
    return pack._replace(land_grid=land_grid, land=field(land_grid),
                         bathy_grid=bathy_grid, bathy=field(bathy_grid))


@pytest.mark.card
def test_two_levels_and_their_variants(cuda_card):
    """C = 21 in the cell; own grids, fused and separate; a cropped basin
    (H and W no multiple of the tile); one plane; a gathered year."""
    cfg = Namelist()
    pack = fields.synthetic_pack(cfg, 18, 181, 360, seed=0,
                                 device=str(cuda_card))
    year = fields.slice_pack_year(pack, cfg, 0)
    assert year.wind.data_ptr() == pack.wind.data_ptr()      # a view
    got = _same(year)
    assert got.cell4.shape == (12, 181, 360, 84) and got.geo_in_cell
    for fused in (True, False):
        got = _same(_own_grids(year, fused, cuda_card))
        assert not got.geo_in_cell and got.fused_geo == fused
    crop = fields.crop_pack(year, cfg, 'NA')
    H, W = crop.grid.nlat, crop.grid.nlon
    pl = kstacks.plan(W, 21)
    assert H % pl.strip and W % pl.tile
    _same(crop)
    _same(year._replace(wind=year.wind[5:6], env=year.env[5:6]))
    # a year past the data: every plane gathered and clamped, vpot zeroed
    gathered = fields.slice_pack_year(pack, cfg, 1)
    assert (gathered.wind.untyped_storage().data_ptr()
            != pack.wind.untyped_storage().data_ptr())
    _same(gathered)


@pytest.mark.card
def test_deep_layer_shapes(cuda_card):
    """The 17-level cell row: 629 wind statistics, 5 env and 2 geo
    channels on 12 planes of the one-degree grid (random values: the
    kernel copies)."""
    gen = torch.Generator(device=cuda_card).manual_seed(5)
    rand = lambda *s: torch.randn(s, generator=gen,       # noqa: E731
                                  device=cuda_card)
    pack = fields.synthetic_pack(Namelist(), 12, 181, 360, seed=0,
                                 device=str(cuda_card))
    pack = pack._replace(wind=rand(12, 181, 360, 629),
                         env=rand(12, 181, 360, 5))
    got = _same(pack)
    assert got.cell4.shape == (12, 181, 360, 4 * 636)


@pytest.mark.card
def test_only_the_kernel_runs(cuda_card):
    """Under the profiler, one build_stacks runs three device kernels, each
    the stacks kernel, and no copy of PyTorch's (the span tc.launch.stacks
    shows on the device's timeline too, and is no kernel)."""
    cfg = Namelist()
    pack = fields.synthetic_pack(cfg, 12, 181, 360, seed=0,
                                 device=str(cuda_card))
    fields.build_stacks(pack)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):       # the card's tracer loses a profile now and then
        kernels.reset_counts()
        with torch.profiler.profile(activities=acts) as prof:
            fields.build_stacks(pack)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.name != 'tc.launch.stacks']
        if names:
            break
    assert kernels.LAUNCHES['stacks'] == 3
    assert 0 < len(names) <= 3, names
    assert all('stack_corners_kernel' in n for n in names), names


@pytest.mark.card
def test_wrapper_refuses(cuda_card):
    """Non-contiguous, float64, mixed grids or devices, too many sources:
    raised before any launch."""
    x = torch.zeros(2, 5, 6, 4, device=cuda_card)
    kernels.reset_counts()
    bad = [[x[..., ::2]], [x.double()], [x.transpose(1, 2)],
           [x, torch.zeros(5, 7, device=cuda_card)],
           [x, torch.zeros(3, 5, 6, 1, device=cuda_card)],
           [x, torch.zeros(5, 6)], [x] * 5]
    for sources in bad:
        with pytest.raises(ValueError):
            kstacks.corner_stack(sources)
    assert kernels.LAUNCHES['stacks'] == 0
    out = kstacks.corner_stack([x[1:], torch.ones(5, 6, device=cuda_card)])
    assert out.shape == (1, 5, 6, 20)
    assert torch.equal(out[..., 4::5], torch.ones(1, 5, 6, 4,
                                                  device=cuda_card))
    assert np.isclose(float(out.sum()), 120.0)
