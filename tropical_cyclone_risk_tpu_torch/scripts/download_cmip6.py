"""CMIP6 (GCM) data acquisition via ESGF search or pre-fetched URL lists
(copy of tropical_cyclone_risk_tpu/scripts/download_cmip6.py).

Reference equivalent: scripts/download_cmip6.py + scripts/GFDL-CM4/wget_*.sh:
the reference bundles pre-generated ESGF wget scripts for six GFDL-CM4
ssp585 variables (ua/va day; hus/psl/ta Amon; tos Omon), which work without
the ESGF search API.  Both acquisition modes are here: the search URLs are
built offline (the query itself needs the network), and pre-fetched
listings -- standard ESGF wget scripts or plain one-URL-per-line text
files -- are read by ``download_all(url_lists=...)`` with no search at all.
Only the file fetch needs the network.
"""

from __future__ import annotations

import os
import re
import urllib.parse
import urllib.request
from typing import Dict, List, Sequence, Tuple

from tropical_cyclone_risk_tpu_torch.config import Namelist

ESGF_SEARCH = 'https://esgf-node.llnl.gov/esg-search/search'

# variable -> table mapping of the reference's bundled wget scripts
# (scripts/GFDL-CM4/wget_{ua,va,hus,psl,ta,tos}*.sh)
DEFAULT_VARIABLES: Dict[str, str] = {
    'ua': 'day', 'va': 'day',
    'hus': 'Amon', 'psl': 'Amon', 'ta': 'Amon',
    'tos': 'Omon',
}


def search_url(variable: str, table: str, source_id: str = 'GFDL-CM4',
               experiment_id: str = 'ssp585', member: str = 'r1i1p1f1',
               limit: int = 500) -> str:
    """ESGF RESTful search URL for one variable's file listing."""
    q = {
        'type': 'File', 'project': 'CMIP6', 'source_id': source_id,
        'experiment_id': experiment_id, 'variant_label': member,
        'variable_id': variable, 'table_id': table,
        'format': 'application/solr+json', 'limit': str(limit),
    }
    return ESGF_SEARCH + '?' + urllib.parse.urlencode(q)


def list_file_urls(variable: str, table: str, **kw) -> List[str]:
    """Query ESGF for HTTPServer download URLs (requires network)."""
    import json
    with urllib.request.urlopen(search_url(variable, table, **kw),
                                timeout=60) as r:
        docs = json.load(r)['response']['docs']
    urls = []
    for d in docs:
        for u in d.get('url', []):
            href, _, kind = u.partition('|')
            if 'HTTPServer' in u:
                urls.append(href.split('|')[0])
    return sorted(set(urls))


# one ESGF-wget download_files entry: 'filename' 'url' 'checksum_type'
# 'checksum' on a single line (the format of the reference's bundled
# scripts/GFDL-CM4/wget_*.sh and of any script the ESGF wget generator
# emits)
_WGET_ENTRY = re.compile(
    r"^\s*'([^']+\.nc)'\s+'(https?://[^']+)'\s+'[^']*'\s+'[^']*'\s*$",
    re.MULTILINE)


def parse_wget_script(text: str) -> List[Tuple[str, str]]:
    """(filename, url) pairs from a standard ESGF wget script's
    download_files section."""
    return [(m.group(1), m.group(2)) for m in _WGET_ENTRY.finditer(text)]


def file_urls_from_lists(paths: Sequence[str]) -> List[Tuple[str, str]]:
    """(filename, url) pairs from pre-fetched listings: ESGF wget scripts
    (detected by their download_files entries) or plain text files with
    one URL per line (# comments allowed).  A directory expands to every
    .sh/.txt file inside it, so the reference's scripts/GFDL-CM4/
    directory can be consumed as-is."""
    expanded: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            expanded.extend(
                os.path.join(p, f) for f in sorted(os.listdir(p))
                if f.endswith(('.sh', '.txt')))
        else:
            expanded.append(p)
    pairs: List[Tuple[str, str]] = []
    for p in expanded:
        with open(p) as f:
            text = f.read()
        entries = parse_wget_script(text)
        if not entries:           # plain URL list
            for line in text.splitlines():
                line = line.strip()
                if line and not line.startswith('#'):
                    name = os.path.basename(urllib.parse.urlparse(line).path)
                    if not name:
                        # a URL ending in '/' (or query-only) derives an
                        # empty filename, which would make download_all
                        # target cfg.base_directory itself and fail in
                        # os.replace — reject it at parse time instead
                        raise ValueError(
                            f'{p}: URL {line!r} has no filename component')
                    entries.append((name, line))
        if not entries:
            raise ValueError(f'{p}: no ESGF wget entries and no URLs found')
        pairs.extend(entries)
    seen: Dict[str, str] = {}
    for name, url in pairs:
        # the same file listed twice with the SAME url is normal (rerun of
        # a listing); the same filename mapping to a DIFFERENT url is a
        # listing conflict that first-wins would silently paper over
        if name in seen and seen[name] != url:
            raise ValueError(
                f'conflicting listings for {name!r}:\n  {seen[name]}\n  {url}')
        seen.setdefault(name, url)
    return sorted(seen.items())


def download_all(cfg: Namelist, variables: Dict[str, str] = None,
                 source_id: str = 'GFDL-CM4',
                 experiment_id: str = 'ssp585',
                 url_lists: Sequence[str] = None) -> List[str]:
    """Download every file of every variable into cfg.base_directory
    (idempotent, like the reference's wget -c loops).

    url_lists: pre-fetched listings (ESGF wget scripts or plain URL
    files, see file_urls_from_lists) — acquisition then needs no live
    ESGF search endpoint, matching the reference's bundled-script mode
    (scripts/download_cmip6.py:17-34)."""
    os.makedirs(cfg.base_directory, exist_ok=True)
    if url_lists is not None:
        entries = file_urls_from_lists(url_lists)
    else:
        variables = variables or DEFAULT_VARIABLES
        entries = [(os.path.basename(url), url)
                   for var, table in variables.items()
                   for url in list_file_urls(var, table, source_id=source_id,
                                             experiment_id=experiment_id)]
    out = []
    for name, url in entries:
        path = os.path.join(cfg.base_directory, name)
        out.append(path)
        if os.path.exists(path):
            continue
        tmp = path + '.part'
        urllib.request.urlretrieve(url, tmp)
        os.replace(tmp, path)
    return out
