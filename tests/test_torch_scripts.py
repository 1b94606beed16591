"""The port's download scripts (scripts/download_era5.py and
scripts/download_cmip6.py) against the JAX package's, offline: the same
request bodies and search URLs, the ESGF wget-script and URL-list parsing
with its conflict and empty-list errors, and download_all(url_lists=...)
idempotent and atomic with urlretrieve replaced by a stub.  Nothing is
fetched (the counterparts of tests/test_analysis.py's download tests).
"""

import os

import pytest

from tropical_cyclone_risk_tpu.config import Namelist as JNamelist
from tropical_cyclone_risk_tpu.scripts import download_cmip6 as jcmip6
from tropical_cyclone_risk_tpu.scripts import download_era5 as jera5
from tropical_cyclone_risk_tpu_torch.config import Namelist
from tropical_cyclone_risk_tpu_torch.scripts import (download_cmip6,
                                                     download_era5)


def test_download_request_shapes():
    """Six ERA5 requests a year (daily winds at 250/850 hPa, 00Z and 12Z),
    the ESGF search URL of a variable, and download_year raising a
    RuntimeError naming cdsapi where the client is not installed."""
    reqs = download_era5.year_requests(2020)
    assert len(reqs) == 6
    names = [r[1] for r in reqs]
    assert 'era5_u_daily_2020.nc' in names and 'era5_sst_2020.nc' in names
    daily = dict((r[1], r[2]) for r in reqs)['era5_u_daily_2020.nc']
    assert daily['pressure_level'] == ['250', '850']
    assert daily['time'] == ['00:00', '12:00']
    url = download_cmip6.search_url('ua', 'day')
    assert 'variable_id=ua' in url and 'GFDL-CM4' in url
    try:
        import cdsapi  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match='cdsapi'):
            download_era5.download_year(Namelist(), 2020)


@pytest.mark.parametrize('year', [1979, 2020])
def test_requests_and_urls_equal_the_jax_package(year):
    """year_requests, the pressure levels and every variable's search URL
    (with the default and another model, experiment and member) equal the
    JAX package's."""
    assert download_era5.year_requests(year) == jera5.year_requests(year)
    assert download_era5.PRESSURE_LEVELS_28 == jera5.PRESSURE_LEVELS_28
    assert download_cmip6.DEFAULT_VARIABLES == jcmip6.DEFAULT_VARIABLES
    for var, table in download_cmip6.DEFAULT_VARIABLES.items():
        assert download_cmip6.search_url(var, table) == jcmip6.search_url(
            var, table)
        kw = dict(source_id='MPI-ESM1-2-HR', experiment_id='historical',
                  member='r2i1p1f1', limit=10)
        assert download_cmip6.search_url(var, table, **kw) == \
            jcmip6.search_url(var, table, **kw)


WGET = ("#!/bin/bash\ndownload_files=$(cat <<EOF--dataset.file.url\n"
        "'ua_day_GFDL-CM4_ssp585_r1i1p1f1_gr1_20150101-20341231.nc' "
        "'http://esgf.example/ua_day_1.nc' 'SHA256' 'abc123'\n"
        "'ua_day_GFDL-CM4_ssp585_r1i1p1f1_gr1_20350101-20541231.nc' "
        "'http://esgf.example/ua_day_2.nc' 'SHA256' 'def456'\n"
        "EOF--dataset.file.url\n)\n")


def test_cmip6_offline_url_lists(tmp_path, monkeypatch):
    """ESGF wget scripts and plain URL lists are read without a search
    endpoint (and as the JAX package reads them); download_all(url_lists=
    ...) fetches each file once, through a .part file, and a rerun fetches
    nothing; an empty list, a conflicting listing and a URL with no file
    name raise ValueError."""
    (tmp_path / 'wget_ua_day.sh').write_text(WGET)
    plain = tmp_path / 'tos_urls.txt'
    plain.write_text("# tos Omon\nhttp://esgf.example/tos_Omon_x.nc\n")

    pairs = download_cmip6.file_urls_from_lists([str(tmp_path)])
    assert ('tos_Omon_x.nc', 'http://esgf.example/tos_Omon_x.nc') in pairs
    assert len(pairs) == 3
    assert sum(n.startswith('ua_day_GFDL-CM4') for n, _ in pairs) == 2
    assert pairs == jcmip6.file_urls_from_lists([str(tmp_path)])
    assert download_cmip6.parse_wget_script(WGET) == \
        jcmip6.parse_wget_script(WGET)

    fetched = []

    def fake_retrieve(url, tmp):
        assert tmp.endswith('.part')
        fetched.append(url)
        with open(tmp, 'wb') as f:
            f.write(b'x')

    monkeypatch.setattr(download_cmip6.urllib.request, 'urlretrieve',
                        fake_retrieve)
    monkeypatch.setattr(
        download_cmip6, 'list_file_urls',
        lambda *a, **k: pytest.fail('search API must not be queried'))
    cfg = Namelist().replace(base_directory=str(tmp_path / 'data'))
    out = download_cmip6.download_all(cfg, url_lists=[str(tmp_path)])
    assert len(out) == 3 and all(os.path.exists(p) for p in out)
    assert not any(f.endswith('.part')
                   for f in os.listdir(tmp_path / 'data'))
    n0 = len(fetched)
    download_cmip6.download_all(cfg, url_lists=[str(tmp_path)])
    assert len(fetched) == n0 == 3

    empty = tmp_path / 'empty.txt'
    empty.write_text('# nothing\n')
    with pytest.raises(ValueError, match='no ESGF wget entries'):
        download_cmip6.file_urls_from_lists([str(empty)])
    dup_ok = tmp_path / 'dup_ok.txt'
    dup_ok.write_text('http://esgf.example/tos_Omon_x.nc\n')
    assert len(download_cmip6.file_urls_from_lists(
        [str(plain), str(dup_ok)])) == 1
    conflict = tmp_path / 'conflict.txt'
    conflict.write_text('http://mirror.example/other/tos_Omon_x.nc\n')
    with pytest.raises(ValueError, match='conflicting listings'):
        download_cmip6.file_urls_from_lists([str(plain), str(conflict)])
    slashy = tmp_path / 'slashy.txt'
    slashy.write_text('http://esgf.example/somedir/\n')
    with pytest.raises(ValueError, match='no filename component'):
        download_cmip6.file_urls_from_lists([str(slashy)])


def test_era5_download_all_years(monkeypatch, tmp_path):
    """download_all runs download_year for every configured year, as the
    JAX package's does, and returns their files in year order."""
    seen = []
    monkeypatch.setattr(download_era5, 'download_year', lambda cfg, y: (
        seen.append(y), [f'{y}.nc'])[1])
    cfg = Namelist().replace(base_directory=str(tmp_path), start_year=2001,
                             end_year=2003)
    assert download_era5.download_all(cfg) == ['2001.nc', '2002.nc',
                                               '2003.nc']
    assert sorted(seen) == [2001, 2002, 2003]
    jcfg = JNamelist().replace(start_year=2001, end_year=2003)
    assert tuple(cfg.years()) == tuple(jcfg.years())
