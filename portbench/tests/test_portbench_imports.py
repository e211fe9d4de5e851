"""Nothing under ``portbench/`` imports JAX or the JAX package, and the
plain reference imports nothing of the program (CPU).  Top-level module
names are compared whole: ``pps_tpu_torch`` begins with ``pps_tpu`` but is
another name."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent
ROOT = PKG.parent
JAX = {'jax', 'jaxlib', 'flax', 'pps_tpu'}
PROGRAM = {'pps_tpu_torch', 'chip_smoke'}
# the yardstick's test holds copies against their origins in the program
YARDSTICK_TEST = 'test_portbench_yardstick.py'


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


SOURCES = sorted(PKG.rglob('*.py'))


def test_the_scan_compares_names_whole():
    src = 'import pps_tpu_torch.engine\nfrom pps_tpu_torch import x\n'
    p = PKG / 'tests' / '_probe_never_written.py'
    tree = ast.parse(src)
    names = {a.name.split('.')[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    assert names == {'pps_tpu_torch'} and not names & JAX
    assert not p.exists()


@pytest.mark.parametrize('path', SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize(
    'path', sorted((PKG / 'reference').rglob('*.py')) + [PKG / 'yardstick.py'],
    ids=lambda p: str(p.relative_to(PKG)))
def test_reference_and_yardstick_import_nothing_of_the_program(path):
    assert not top_level_imports(path) & PROGRAM


BLOCKER = '''
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def __init__(self, names): self.names = set(names)
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in self.names:
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block(sys.argv[1].split(',')))
sys.path.insert(0, sys.argv[2])
import importlib
for mod in sys.argv[3].split(','):
    importlib.import_module(mod)
print('imported')
'''


def _import_with(blocked, modules):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    return subprocess.run(
        [sys.executable, '-c', BLOCKER, ','.join(blocked), str(ROOT),
         ','.join(modules)], capture_output=True, text=True, timeout=120,
        env=env)


def test_the_harness_imports_with_jax_blocked():
    mods = ['portbench.run', 'portbench.core', 'portbench.readings',
            'portbench.sweep', 'portbench.synth', 'portbench.readers',
            'portbench.drivers.train', 'portbench.drivers.test_pass',
            'portbench.drivers.open_loop_search']
    r = _import_with(sorted(JAX), mods)
    assert r.returncode == 0 and 'imported' in r.stdout, r.stderr[-2000:]


def test_the_reference_imports_with_the_program_blocked():
    mods = ['portbench.reference.pps', 'portbench.reference.evaluation',
            'portbench.reference.retrieval', 'portbench.yardstick']
    r = _import_with(sorted(JAX | PROGRAM), mods)
    assert r.returncode == 0 and 'imported' in r.stdout, r.stderr[-2000:]


def test_a_blocked_name_is_refused():
    r = _import_with(['pps_tpu'], ['pps_tpu'])
    assert r.returncode != 0 and 'blocked: pps_tpu' in r.stderr


def test_loaded_forbidden_compares_whole_names():
    from portbench import run
    before = dict(sys.modules)
    try:
        sys.modules.setdefault('pps_tpu_torch', object())
        assert 'pps_tpu' not in run.loaded_forbidden() or 'pps_tpu' in before
        sys.modules['jaxlib_probe_fake'] = object()
        assert 'jaxlib_probe_fake' not in run.loaded_forbidden()
    finally:
        sys.modules.pop('jaxlib_probe_fake', None)
