"""The port's config is a copy of pps_tpu's: equal key by key after the
same merges, and the same errors for bad keys."""

from pathlib import Path

import numpy as np
import pytest

import pps_tpu.config as jcfg
import pps_tpu_torch.config as tcfg
from __graft_entry__ import _flagship_cfg
from pps_tpu_torch.flagship import flagship_cfg

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP_YAML = REPO / 'configs/market1501/pps_crm_triplet_R-50_1x.yaml'


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


def _assert_same(a, b, path=''):
    assert type(a).__name__ == type(b).__name__, (path, type(a), type(b))
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _assert_same(a[k], b[k], path + '.' + k)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def test_defaults_equal():
    _assert_same(dict(jcfg.cfg), dict(tcfg.cfg))


def test_flagship_merge_list_equal():
    _assert_same(dict(_flagship_cfg()), dict(flagship_cfg()))
    assert tcfg.cfg.is_immutable()


@pytest.mark.parametrize('scale,dtype', [((32, 96), 'float32'),
                                         ((128, 384), 'bfloat16')])
def test_flagship_variants_equal(scale, dtype):
    a = _flagship_cfg(scale=scale, num_classes=11, dtype=dtype)
    b = flagship_cfg(scale=scale, num_classes=11, dtype=dtype)
    _assert_same(dict(a), dict(b))


def test_merge_cfg_from_file_equal():
    jcfg.merge_cfg_from_file(str(FLAGSHIP_YAML))
    tcfg.merge_cfg_from_file(str(FLAGSHIP_YAML))
    _assert_same(dict(jcfg.cfg), dict(tcfg.cfg))
    jcfg.assert_and_infer_cfg()
    tcfg.assert_and_infer_cfg()
    _assert_same(dict(jcfg.cfg), dict(tcfg.cfg))
    assert tcfg.cfg.REID.SCALE == (128, 384)
    assert tcfg.cfg.TPU.DEVICE_PREPROC is True


@pytest.mark.parametrize('pairs,exc', [
    (['MODEL.NO_SUCH_KEY', '1'], AssertionError),
    (['MODEL.NUM_CLASSES', "'abc'"], ValueError),
    (['EXAMPLE.RENAMED.KEY', '1'], KeyError),
])
def test_merge_list_errors_equal(pairs, exc):
    with pytest.raises(exc):
        jcfg.merge_cfg_from_list(pairs)
    with pytest.raises(exc):
        tcfg.merge_cfg_from_list(pairs)


def test_yaml_string_and_ignored_keys(tmp_path):
    text = 'MODEL:\n  NUM_CLASSES: 9\nRPN:\n  ON: True\n'
    assert tcfg.load_cfg(text) == jcfg.load_cfg(text)
    f = tmp_path / 'c.yaml'
    f.write_text(text)
    jcfg.merge_cfg_from_file(str(f))
    tcfg.merge_cfg_from_file(str(f))
    _assert_same(dict(jcfg.cfg), dict(tcfg.cfg))
    f.write_text('MODEL:\n  TYPO_KEY: 1\n')
    with pytest.raises(KeyError):
        tcfg.merge_cfg_from_file(str(f))


def test_url_weights_rejected():
    tcfg.merge_cfg_from_list(['TEST.WEIGHTS', 'https://example.com/w.pkl'])
    with pytest.raises(ValueError, match='URL'):
        tcfg.assert_and_infer_cfg(make_immutable=False)
