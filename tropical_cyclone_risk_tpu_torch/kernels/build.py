"""Build a CUDA source of csrc/ into a shared library with nvcc.

Each library has a plain C interface (no PyTorch headers), which keeps a
build to seconds; the wrappers bind it with ctypes.  It goes to ``build/``
at the repository root, named by a hash of the source, every header of
csrc/, the flags and the unit's definitions, so a changed source or shared
header is rebuilt and a built one is reused.  A source may build into
several libraries, one per set of preprocessor definitions (K1's units of
a steering-level count and the in-scan vmax).  Different libraries build
independently, so callers may build them in parallel threads.
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
def library(name: str, defines: tuple = ()) -> dict:
    """Compile csrc/{name}.cu with the definitions ((macro, value), ...) if
    it is not built yet.  Returns {'path', 'seconds', 'log'}: the library,
    the build time (0 when it was already built) and nvcc's register/spill
    report."""
    source = PKG / 'csrc' / f'{name}.cu'
    headers = sorted((PKG / 'csrc').glob('*.cuh'))
    flags = NVCC_FLAGS + tuple(f'-D{k}={v}' for k, v in defines)
    tag = hashlib.sha256(b''.join(p.read_bytes() for p in [source, *headers])
                         + ' '.join(flags).encode()).hexdigest()[:16]
    unit = ''.join(f'_{v}' for _, v in defines)
    out = BUILD_DIR / f'libtc_{name}{unit}_{tag}.so'
    if out.exists():
        return {'path': out, 'seconds': 0.0, 'log': ''}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    t0 = time.perf_counter()
    res = subprocess.run([_nvcc(), *flags, '-o', str(tmp), str(source)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f'nvcc failed on {source.name} '
                           f'({res.returncode}):\n{res.stderr}')
    os.replace(tmp, out)
    return {'path': out, 'seconds': time.perf_counter() - t0,
            'log': res.stdout + res.stderr}
