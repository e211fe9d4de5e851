"""Shared set-up of the measurement tools' tests: the port's cfg reset
around each test, torch on two threads, each test's files freed when it
ends, and the tools' model narrowed through their ``tool_cfg`` hook.

A test module imports the fixtures it uses from here."""

import shutil

import pytest
import torch

from pps_tpu_torch import config as tcfg
from pps_tpu_torch.flagship import flagship_cfg
from pps_tpu_torch.tools import common

# the narrowed flagship: 96x32 images, an eighth of the body's inner
# widths, 3 strips of 16-d (7 combos, a 112-d embedding)
NARROW = ['RESNETS.WIDTH_PER_GROUP', '8', 'REID.BPM_DIM', '16',
          'REID.BPM_STRIP_NUM', '3']
SCALE = (32, 96)
DIM = 7 * 16


def narrow_cfg(scale=None, **kw):
    """``flagship_cfg`` at the test size, whatever scale is asked for."""
    cfg = flagship_cfg(scale=SCALE, **kw)
    cfg.immutable(False)
    tcfg.merge_cfg_from_list(NARROW)
    tcfg.assert_and_infer_cfg()
    return cfg


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    """Two intra-op threads: the suite runs six workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope='module')
def _grad_enabled():
    """Autograd on for the module: another test module of the suite turns
    it off for its whole worker."""
    with torch.enable_grad():
        yield


@pytest.fixture
def narrow(monkeypatch):
    """The tools build the narrowed model."""
    monkeypatch.setattr(common, 'tool_cfg', narrow_cfg)


@pytest.fixture
def tmp_path(tmp_path):
    """Each test's files are freed when it ends: pytest keeps every
    test's directory until the whole run ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)
