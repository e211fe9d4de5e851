"""A mixed-size dataset through the drivers, against pps_tpu: a tiny
``train_model`` on the padded uint8 wire on both sides from one
TRAIN.WEIGHTS pkl (the same plans, LRs, loss_scale_factors and checkpoint
names, every batch padded, the first loss within 1e-4), then
``run_inference`` with the port's final pkl on both sides over a
mixed-size test split (features within 1e-4, every batch of the port
'u8p', the same printed metrics).

Augmentation and dropout are off, so the first step is deterministic on
both sides; later losses are not compared (ROADMAP, "Noted while
porting")."""

import json
import logging
import shutil

import numpy as np
import pytest
import torch

from pps_tpu.data import catalog as jcatalog
from pps_tpu.data import loader as jloader
from pps_tpu.engine import test as jtest_engine
from pps_tpu.engine import train as jtrain
from pps_tpu.parallel import train_step as jts
from pps_tpu.solver import optimizer as jopt
from pps_tpu.utils.io import load_object
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.data import catalog as tcatalog
from pps_tpu_torch.data import loader as tloader
from pps_tpu_torch.engine import checkpoint as tckpt
from pps_tpu_torch.engine import test as ttest_engine
from pps_tpu_torch.engine import train as ttrain
from pps_tpu_torch.models.model import build_model as tbuild
from pps_tpu_torch.parallel import train_step as tts
from pps_tpu_torch.solver import optimizer as topt

from test_torch_port_data import both_cfgs
from test_torch_port_driver import TINY_TRAIN, _indices, _losses, _record
from test_torch_port_mixed import mixed_decoder, write_mixed

N_IDS = 6
LOSS_RTOL = 1e-4  # the first loss: a forward value, float32 on both sides
FEAT_ATOL = 1e-4  # features through 53 float32 convs, another sum order
OPTS = [o.replace('port_drv_trainval', 'port_mix_trainval')
        for o in TINY_TRAIN] + [
    'SOLVER.MAX_ITER', '1', 'REID.RERANK', 'False',
    'TEST.DATASETS', "('port_mix_test',)", 'TEST.IMS_PER_BATCH', '8']


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    """Two intra-op threads: the suite runs six workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope='module')
def _grad_enabled():
    """Autograd on for this module: another test module of the suite turns
    it off for the whole process when it is imported."""
    with torch.enable_grad():
        yield


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp('mixed_driver')
    for split, per_id, marks in (('trainval', 2, False), ('test', 3, True)):
        imdir, ann = write_mixed(root / split, split, N_IDS, per_id,
                                 with_marks=marks, n_cams=3)
        for cat in (jcatalog, tcatalog):
            cat.register_dataset('port_mix_' + split, imdir, ann)
    weights = str(root / 'weights.pkl')
    tcfg.reset_cfg()
    _, tc = both_cfgs(OPTS)
    model = tbuild(tc, device='cpu')
    params, state = model.init(torch.Generator().manual_seed(0))
    tckpt.save_checkpoint(weights, model, params, state)
    opts = OPTS + ['TRAIN.WEIGHTS', weights]
    dec = mixed_decoder()
    out = {'root': root, 'opts': opts, 'decode': dec, 'batches': []}
    from pps_tpu.config import reset_cfg as jreset
    with pytest.MonkeyPatch.context() as mp:
        jreset()
        tcfg.reset_cfg()
        jc, tc = both_cfgs(opts)
        out['jax'] = _record(mp, jloader.ReIDLoader, jts, jopt)
        jtrain.train_model(jc, output_dir=str(root / 'jax'), decode_fn=dec,
                           num_workers=2)
        out['port'] = _record(mp, tloader.ReIDLoader, tts, topt)
        recorded = tloader.ReIDLoader.iter_epoch

        def seen(loader, ep, start_step=0):
            for item in recorded(loader, ep, start_step):
                out['batches'].append(sorted(item[2]))
                yield item
        mp.setattr(tloader.ReIDLoader, 'iter_epoch', seen)
        out['port_ckpts'] = ttrain.train_model(
            tc, output_dir=str(root / 'port'), decode_fn=dec, num_workers=2,
            device='cpu')
    jreset()
    for side in ('jax', 'port'):
        out[side + '_names'] = sorted(p.name for p in (root / side).iterdir())
    shutil.rmtree(str(root / 'jax'))
    yield out
    shutil.rmtree(str(root), ignore_errors=True)


def test_mixed_train_model_matches(runs):
    j, t = runs['jax'], runs['port']
    assert len(t['steps']) == len(j['steps']) > 0
    assert [s[:2] for s in t['steps']] == [s[:2] for s in j['steps']]
    assert t['at'] == j['at']
    assert _indices(t) == _indices(j)
    assert t['corrections'] == j['corrections']
    np.testing.assert_allclose(_losses(t)[0], _losses(j)[0], rtol=LOSS_RTOL)
    assert np.isfinite(_losses(t)).all()
    assert runs['port_names'] == runs['jax_names']
    # every batch on the padded wire
    assert runs['batches'] and all(
        b == ['data_u8', 'flipped', 'labels_int32', 'labels_oh', 'valid_hw']
        for b in runs['batches'])


def test_mixed_run_inference_matches(runs, tmp_path, capsys, caplog):
    final = runs['port_ckpts']['final']
    jc, tc = both_cfgs(runs['opts'])
    want = jtest_engine.run_inference(jc, final, str(tmp_path / 'j'),
                                      decode_fn=runs['decode'])
    want_out = capsys.readouterr().out
    with caplog.at_level(logging.INFO, logger='pps_tpu_torch'):
        got = ttest_engine.run_inference(tc, final, str(tmp_path / 't'),
                                         decode_fn=runs['decode'],
                                         device='cpu')
    got_out = capsys.readouterr().out
    jf = load_object(str(tmp_path / 'j' / 'features.pkl'))['all_feats']
    tf = load_object(str(tmp_path / 't' / 'features.pkl'))['all_feats']
    assert tf.shape == jf.shape == (N_IDS * 3, 3968)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=FEAT_ATOL)
    line = [r.getMessage() for r in caplog.records
            if 'batch kinds' in r.getMessage()][-1]
    assert json.loads(line.split('batch kinds: ')[1]) == {
        'u8p': 3, 'u8': 0, 'f32': 0}
    assert [ln for ln in got_out.splitlines() if 'Query:' in ln] == \
        [ln for ln in want_out.splitlines() if 'Query:' in ln]
    res = got['port_mix_test']['single']
    want_res = want['port_mix_test']['single']
    assert abs(res['mAP'] - want_res['mAP']) < 1e-6
    shutil.rmtree(str(tmp_path), ignore_errors=True)
