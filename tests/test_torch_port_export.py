"""The export tool (``pps_tpu_torch/tools/export_model.py``): the folded and
the int8 extraction through ``torch.export``, saved, reloaded and run on
the CPU, equal to eager extraction; the int8 conv stays one custom-op node
per body conv.  Modelled on ``tests/test_export.py``."""

import numpy as np
import pytest
import torch

from _torch_port_variants_common import _two_threads, tmp_path
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.engine import checkpoint as tckpt
from pps_tpu_torch.models.folding import fold_conv_bn
from pps_tpu_torch.models.model import build_model
from pps_tpu_torch.models.quantize import quantize_for_eval
from pps_tpu_torch.tools import export_model

TINY = ['MODEL.TYPE', 'generalized_reid',
        'MODEL.CONV_BODY', 'ResNet.add_ResNet50_conv5_body',
        'MODEL.NUM_CLASSES', '5', 'MODEL.USE_BN', 'True',
        'FAST_RCNN.ROI_BOX_HEAD', 'pps_heads.add_pps_part_head',
        'RESNETS.RES5_STRIDE', '1',
        'REID.SCALE', '(32, 96)', 'REID.BPM_STRIP_NUM', '3',
        'REID.BPM_DIM', '8', 'REID.NORMALIZE_FEATURE', 'True']
# the exported program runs the same aten ops (and the same int8 op) as
# eager extraction on the same CPU
ATOL = 1e-6


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


def _model():
    tcfg.merge_cfg_from_list(TINY)
    tcfg.assert_and_infer_cfg(make_immutable=False)
    model = build_model(tcfg.cfg, device='cpu')
    params, state = model.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    state = {k: torch.tensor((rng.randn(*v.shape) * 0.1 if k.endswith('_rm')
                              else rng.rand(*v.shape) + 0.5).astype(
                                  np.float32))
             for k, v in sorted(state.items())}
    return model, params, state


def _round_trip(model, params, state, tmp_path):
    program = torch.export.export(
        export_model._module(model, params, state),
        (torch.zeros(2, 96, 32, 3),))
    path = str(tmp_path / 'model.pt2')
    torch.export.save(program, path)
    reloaded = torch.export.load(path)
    x = torch.tensor(np.random.RandomState(1).randn(2, 96, 32, 3).astype(
        np.float32) * 50)
    got = reloaded.module()(x)
    want = model.extract_features(params, state, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)
    p, s = export_model.split_state(reloaded)
    assert sorted(p) == sorted(params) and sorted(s) == sorted(state)
    for k, v in params.items():
        assert p[k].dtype == v.dtype and torch.equal(p[k], v), k
    return reloaded


def test_export_folded_round_trip(tmp_path):
    model, params, state = _model()
    _round_trip(model, fold_conv_bn(params, state), state, tmp_path)


def test_export_int8_round_trip(tmp_path):
    model, params, state = _model()
    calib = np.random.RandomState(2).randn(4, 96, 32, 3).astype(
        np.float32) * 50
    qparams = quantize_for_eval(model, params, state, calib, batch_size=4)
    reloaded = _round_trip(model, qparams, state, tmp_path)
    ops = [n for gm in reloaded.graph_module.modules()
           if isinstance(gm, torch.fx.GraphModule) for n in gm.graph.nodes
           if n.op == 'call_function' and 'conv2d_int8' in str(n.target)]
    assert len(ops) == 53


@pytest.mark.parametrize('mode', ['--fold-bn', '--int8'])
def test_export_tool_on_cpu(tmp_path, mode):
    """The CLI from a weights pkl (int8: calibrated on a .npy)."""
    model, params, state = _model()
    weights = str(tmp_path / 'w.pkl')
    tckpt.save_checkpoint(weights, model, params, state)
    calib = str(tmp_path / 'calib.npy')
    np.save(calib, np.random.RandomState(3).randn(4, 96, 32, 3).astype(
        np.float32) * 50)
    out = str(tmp_path / 'm.pt2')
    tcfg.reset_cfg()
    cfg_file = str(tmp_path / 'tiny.yaml')
    with open(cfg_file, 'w') as f:
        f.write('MODEL:\n  TYPE: generalized_reid\n')
    err = export_model.main(['--cfg', cfg_file, '--weights', weights,
                             '--out', out, '--batch', '2', mode,
                             '--calib-npy', calib, '--device', 'cpu'] + TINY)
    assert err <= ATOL
    assert torch.export.load(out).module()(
        torch.zeros(2, 96, 32, 3)).shape == (2, 7 * 8)


def test_export_int8_needs_calibration(tmp_path):
    cfg_file = str(tmp_path / 'tiny.yaml')
    with open(cfg_file, 'w') as f:
        f.write('MODEL:\n  TYPE: generalized_reid\n')
    with pytest.raises(SystemExit):
        export_model.main(['--cfg', cfg_file, '--out', str(tmp_path / 'x'),
                           '--int8', '--device', 'cpu'] + TINY)
