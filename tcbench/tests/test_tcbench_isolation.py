"""Every module of the benchmark imports with JAX and the JAX package
blocked, and every module of its reference with the port blocked too
(top-level module names compared whole: the port's name begins with the
JAX package's)."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / 'tcbench'
JAX_SIDE = ('jax', 'jaxlib', 'flax', 'tropical_cyclone_risk_tpu')
PORT = 'tropical_cyclone_risk_tpu_torch'

BLOCKER = '''
import importlib.abc, sys
BLOCKED = set(sys.argv[1].split(','))
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError('blocked: ' + name)
        return None
sys.meta_path.insert(0, Block())
import importlib, importlib.util
for mod in sys.argv[2].split(','):
    if mod.endswith('.py'):
        spec = importlib.util.spec_from_file_location('m', mod)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    else:
        importlib.import_module(mod)
loaded = {m.split('.')[0] for m in sys.modules}
bad = sorted(loaded & BLOCKED)
assert not bad, bad
'''


def modules(sub=''):
    base = BENCH / sub if sub else BENCH
    out = []
    for p in sorted(base.rglob('*.py')):
        rel = p.relative_to(ROOT)
        if 'tests' in rel.parts:
            continue
        if p.parent.name == 'metrics':
            out.append(str(p))
        else:
            out.append('.'.join(rel.with_suffix('').parts).replace(
                '.__init__', ''))
    return out


def run_blocked(blocked, mods):
    return subprocess.run([sys.executable, '-c', BLOCKER, ','.join(blocked),
                           ','.join(mods)], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize('mod', modules())
def test_imports_without_jax(mod):
    res = run_blocked(JAX_SIDE, [mod])
    assert res.returncode == 0, res.stderr[-2000:]


@pytest.mark.parametrize('mod', modules('reference'))
def test_reference_imports_nothing_of_the_port(mod):
    res = run_blocked(JAX_SIDE + (PORT,), [mod])
    assert res.returncode == 0, res.stderr[-2000:]


def test_blocker_sees_whole_names():
    """Blocking the JAX package leaves the port importable: the names are
    compared whole, not by prefix."""
    res = run_blocked(JAX_SIDE, [f'{PORT}.config'])
    assert res.returncode == 0, res.stderr[-2000:]
    res = run_blocked(JAX_SIDE + (PORT,), [f'{PORT}.config'])
    assert res.returncode != 0
