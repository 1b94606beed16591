"""Build a CUDA source of csrc/ into a shared library with nvcc.

Each library has a plain C interface (no PyTorch headers), which keeps a
build to seconds; the wrappers bind it with ctypes.  It goes to ``build/``
at the repository root, named by a hash of the source and flags, so a
changed source is rebuilt and a built one is reused.  Different sources
build independently, so callers may build them in parallel threads.
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG.parent / 'build'
# no --use_fast_math, and no FMA contraction: each operation rounds as the
# separate torch kernels of the plain twins do
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-Xptxas=-v', '-shared',
              '-Xcompiler', '-fPIC')


def _nvcc() -> str:
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    path = Path(home) / 'bin' / 'nvcc'
    if path.exists():
        return str(path)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME)')
    return found


@functools.cache
def library(name: str) -> dict:
    """Compile csrc/{name}.cu if it is not built yet.  Returns {'path',
    'seconds', 'log'}: the library, the build time (0 when it was already
    built) and nvcc's register/spill report."""
    source = PKG / 'csrc' / f'{name}.cu'
    tag = hashlib.sha256(source.read_bytes() +
                         ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f'libtc_{name}_{tag}.so'
    if out.exists():
        return {'path': out, 'seconds': 0.0, 'log': ''}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    t0 = time.perf_counter()
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(source)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f'nvcc failed on {source.name} '
                           f'({res.returncode}):\n{res.stderr}')
    os.replace(tmp, out)
    return {'path': out, 'seconds': time.perf_counter() - t0,
            'log': res.stdout + res.stderr}
