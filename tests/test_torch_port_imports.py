"""The PyTorch port stands alone: it imports neither jax nor pps_tpu, and
its entry points refuse to fall back to the CPU unless asked."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pps_tpu_torch import config as tcfg
from pps_tpu_torch.device import resolve_device
from pps_tpu_torch.flagship import flagship_cfg

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / 'pps_tpu_torch'


def _port_modules():
    mods = []
    for path in sorted(PKG.rglob('*.py')):
        rel = path.relative_to(REPO).with_suffix('')
        parts = list(rel.parts)
        if parts[-1] == '__init__':
            parts = parts[:-1]
        mods.append('.'.join(parts))
    return mods


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


# Runs in a fresh interpreter (this one has jax loaded by conftest): jax,
# pps_tpu, orbax and yaml are removed from sys.modules and blocked by a
# meta-path
# finder, then every port module is imported and the flagship cfg built.
_CHILD = r'''
import importlib, importlib.abc, sys
BLOCK = ('jax', 'pps_tpu', 'orbax', 'yaml')
def blocked(name):
    return any(name == b or name.startswith(b + '.') for b in BLOCK)
class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError('blocked import: ' + name)
        return None
for m in [m for m in sys.modules if blocked(m)]:
    del sys.modules[m]
sys.meta_path.insert(0, Blocker())
for m in sys.argv[1:]:
    importlib.import_module(m)
from pps_tpu_torch.flagship import flagship_cfg
cfg = flagship_cfg()
assert cfg.MODEL.DTYPE == 'bfloat16'
import chip_smoke
bad = sorted(m for m in sys.modules if blocked(m))
print('LOADED', bad)
sys.exit(1 if bad else 0)
'''


def test_port_imports_without_jax_or_pps_tpu():
    mods = _port_modules()
    assert 'pps_tpu_torch.kernels.zero_even' in mods
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, '-c', _CHILD, *mods], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert 'LOADED []' in r.stdout


_FORBIDDEN = re.compile(
    r'^\s*(import\s+jax\b|from\s+jax\b|import\s+pps_tpu\b|from\s+pps_tpu\b|'
    r'import\s+orbax\b|from\s+orbax\b)', re.MULTILINE)


@pytest.mark.parametrize('path', sorted(
    str(p.relative_to(REPO)) for p in
    [*PKG.rglob('*.py'), REPO / 'chip_smoke.py']))
def test_source_has_no_forbidden_import(path):
    text = (REPO / path).read_text()
    assert not _FORBIDDEN.findall(text), path


# torch.distributed is imported inside the functions that use it: an
# install without it (torch.distributed.is_available() False) still
# imports every module
_MODULE_LEVEL_DIST = re.compile(
    r'^(import\s+torch\.distributed\b|from\s+torch\.distributed\b|'
    r'from\s+torch\s+import\s+distributed\b)', re.MULTILINE)


@pytest.mark.parametrize('path', sorted(
    str(p.relative_to(REPO)) for p in
    [*PKG.rglob('*.py'), REPO / 'chip_smoke.py']))
def test_no_module_level_torch_distributed_import(path):
    text = (REPO / path).read_text()
    assert not _MODULE_LEVEL_DIST.findall(text), path


def test_data_parallel_modules_are_scanned():
    mods = _port_modules()
    for m in ('parallel.mesh', 'parallel.collectives', 'parallel.retrieval'):
        assert 'pps_tpu_torch.' + m in mods
    assert _MODULE_LEVEL_DIST.search('import torch.distributed as dist')
    assert _MODULE_LEVEL_DIST.search('from torch.distributed import nn')
    assert not _MODULE_LEVEL_DIST.search('    import torch.distributed')


def test_forbidden_pattern_matches_only_the_jax_package():
    assert _FORBIDDEN.search('from pps_tpu.models import resnet')
    assert _FORBIDDEN.search('import pps_tpu')
    assert _FORBIDDEN.search('    import jax.numpy as jnp')
    assert not _FORBIDDEN.search('from pps_tpu_torch.models import resnet')
    assert not _FORBIDDEN.search('import pps_tpu_torch')
    # orbax by its name or as the prefix 'orbax.'
    assert _FORBIDDEN.search('    import orbax.checkpoint as ocp')
    assert _FORBIDDEN.search('from orbax import checkpoint')
    assert _FORBIDDEN.search('import orbax')
    assert not _FORBIDDEN.search('import orbaxish')


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    from pps_tpu_torch.engine.serving import RetrievalIndex
    from pps_tpu_torch.models.model import build_model
    cfg = flagship_cfg(scale=(32, 96), num_classes=11, dtype='float32')
    feats = torch.randn(4, 8).numpy()
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == 'cuda'
        return
    with pytest.raises(RuntimeError, match='no CUDA device'):
        build_model(cfg)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        RetrievalIndex(feats, list(range(4)))
    assert build_model(cfg, device='cpu').device.type == 'cpu'
    assert len(RetrievalIndex(feats, list(range(4)), device='cpu')) == 4


def test_resolve_device_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    assert resolve_device('cpu') == torch.device('cpu')
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(ValueError):
        resolve_device('meta')
