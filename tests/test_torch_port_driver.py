"""The train driver against pps_tpu's: ``find_resume_checkpoint`` over
the same names; a tiny ``train_model`` on both sides (R-50 at 96x32, 8
identities, augmentation and dropout off) from one TRAIN.WEIGHTS pkl, with
identical sequences of LR, loss_scale_factor, batch indices, checkpoint
names and momentum-correction steps, and the first loss within 1e-4; the
port's preempt-plus-resume bitwise equal to its continuous run; SIGTERM,
the NaN abort, and the CLI (a subprocess run, and exit 75 on
``Preempted``).

Later losses are not compared with pps_tpu's: its jitted gradient differs
from its own op-by-op one (ROADMAP, "Noted while porting")."""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pps_tpu.data import catalog as jcatalog
from pps_tpu.data import loader as jloader
from pps_tpu.engine import checkpoint as jckpt
from pps_tpu.engine import train as jtrain
from pps_tpu.parallel import train_step as jts
from pps_tpu.solver import optimizer as jopt
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.data import catalog as tcatalog
from pps_tpu_torch.data import loader as tloader
from pps_tpu_torch.engine import checkpoint as tckpt
from pps_tpu_torch.engine import train as ttrain
from pps_tpu_torch.models.model import build_model as tbuild
from pps_tpu_torch.parallel import train_step as tts
from pps_tpu_torch.solver import optimizer as topt
from pps_tpu_torch.utils.io import load_object

from test_torch_port_data import both_cfgs, decoder, write_coco

REPO = Path(__file__).resolve().parents[1]
N_IDS, PER_ID = 8, 2
RAW_HW = (48, 20)
LOSS_RTOL = 1e-4  # the first loss: a forward value, float32 on both sides
TINY_TRAIN = [
    'MODEL.TYPE', 'generalized_reid',
    'MODEL.CONV_BODY', 'ResNet.add_ResNet50_conv5_body',
    'MODEL.NUM_CLASSES', str(N_IDS + 1), 'MODEL.USE_BN', 'True',
    'MODEL.DTYPE', 'float32',
    'FAST_RCNN.ROI_BOX_HEAD', 'pps_heads.add_pps_part_head',
    'RESNETS.RES5_STRIDE', '1', 'TRAIN.FREEZE_AT', '0',
    'TRAIN.DATASETS', "('port_drv_trainval',)", 'TRAIN.IMS_PER_BATCH', '8',
    'TRAIN.SNAPSHOT_ITERS', '1',
    # the LR halves at epoch 2: a momentum correction mid-run
    'SOLVER.BASE_LR', '0.002', 'SOLVER.LR_POLICY', 'steps_with_decay',
    'SOLVER.STEPS', '[0, 2]', 'SOLVER.GAMMA', '0.5', 'SOLVER.MAX_ITER', '3',
    'REID.SCALE', '(32, 96)', 'REID.BPM_STRIP_NUM', '5',
    'REID.BPM_DIM', '128', 'REID.CRM', 'True',
    'REID.TRIPLET_LOSS', 'True', 'REID.TRIPLET_LOSS_CROSS', 'True',
    'REID.TRIPLET_LOSS_START', '0',  # epoch 1 is a triplet epoch
    'REID.NORMALIZE_FEATURE', 'True', 'REID.MAX_AVE_FEATURE', 'True',
    'REID.P', '4', 'REID.K', '2', 'TPU.NUM_DEVICES', '1']


@pytest.fixture
def tmp_path(tmp_path):
    """Each test's checkpoints (~100-250 MB each) are freed when it ends:
    pytest keeps every test's directory until the session ends, and the
    suite's later tests need that disk."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    """Two intra-op threads: the suite runs six workers on one host, and
    each worker's default of one thread per core oversubscribes it (these
    R-50 runs measured up to 20x slower there than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


@pytest.fixture(autouse=True, scope='module')
def _grad_enabled():
    """Autograd on for this module: another test module of the suite turns
    it off for the whole process when it is imported."""
    with torch.enable_grad():
        yield


class AfterSteps(object):
    """A preempt_event whose is_set() turns True at its n-th poll; the
    loop polls once per step."""

    def __init__(self, n):
        self.calls, self.n = 0, n

    def clear(self):
        pass

    def is_set(self):
        self.calls += 1
        return self.calls >= self.n


def _record(mp, loader_cls, ts_module, opt_module):
    """Wrap a package's loader, train step and momentum correction to
    record each epoch's plan, each step's (epoch, step in epoch), LR,
    loss_scale_factor and loss, and each momentum correction's step."""
    rec = {'plans': {}, 'at': [], 'steps': [], 'corrections': []}
    plan_epoch, iter_epoch = loader_cls.plan_epoch, loader_cls.iter_epoch
    make_step, correct = ts_module.make_train_step, opt_module.correct_momentum

    def plan(self, ep):
        out = plan_epoch(self, ep)
        rec['plans'][ep] = [list(p[3]) for p in out]
        return out

    def iterate(self, ep, start_step=0):
        for item in iter_epoch(self, ep, start_step):
            rec['at'].append((ep, item[0]))
            yield item

    def make(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def recorded(*a, **k):
            out = step(*a, **k)
            rec['steps'].append((float(a[2]), float(a[3]), out[1]['loss']))
            return out
        return recorded

    def corrected(opt_state, factor):
        rec['corrections'].append((len(rec['steps']), float(factor)))
        return correct(opt_state, factor)

    mp.setattr(loader_cls, 'plan_epoch', plan)
    mp.setattr(loader_cls, 'iter_epoch', iterate)
    mp.setattr(ts_module, 'make_train_step', make)
    mp.setattr(opt_module, 'correct_momentum', corrected)
    return rec


def _indices(rec):
    return [rec['plans'][ep][i] for ep, i in rec['at']]


def _losses(rec):
    return [float(np.asarray(s[2])) for s in rec['steps']]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """One weights pkl; pps_tpu's train_model and the port's, recorded."""
    root = tmp_path_factory.mktemp('driver')
    imdir, ann = write_coco(root, 'trainval', N_IDS, PER_ID, hw=RAW_HW)
    for cat in (jcatalog, tcatalog):
        cat.register_dataset('port_drv_trainval', imdir, ann)
    weights = str(root / 'weights.pkl')
    tcfg.reset_cfg()
    _, tc = both_cfgs(TINY_TRAIN)
    model = tbuild(tc, device='cpu')
    params, state = model.init(torch.Generator().manual_seed(0))
    tckpt.save_checkpoint(weights, model, params, state)
    opts = TINY_TRAIN + ['TRAIN.WEIGHTS', weights]
    dec = decoder(RAW_HW)
    out = {'root': root, 'opts': opts, 'decode': dec}
    from pps_tpu.config import reset_cfg as jreset
    with pytest.MonkeyPatch.context() as mp:
        jreset()
        tcfg.reset_cfg()
        jc, tc = both_cfgs(opts)
        out['jax'] = _record(mp, jloader.ReIDLoader, jts, jopt)
        out['jax_ckpts'] = jtrain.train_model(
            jc, output_dir=str(root / 'jax'), decode_fn=dec, num_workers=2)
        out['port'] = _record(mp, tloader.ReIDLoader, tts, topt)
        out['port_ckpts'] = ttrain.train_model(
            tc, output_dir=str(root / 'port'), decode_fn=dec, num_workers=2,
            device='cpu')
    jreset()
    # keep the names; free all but the port's final checkpoint (~250 MB
    # each) while the module's other tests run
    for side in ('jax', 'port'):
        out[side + '_names'] = sorted(os.listdir(str(root / side)))
    shutil.rmtree(str(root / 'jax'))
    for name in out['port_names']:
        if name != 'model_final.pkl':
            os.remove(str(root / 'port' / name))
    yield out
    shutil.rmtree(str(root), ignore_errors=True)


def test_train_model_matches_pps_tpu(runs):
    j, t = runs['jax'], runs['port']
    assert len(t['steps']) == len(j['steps']) == 4 + 2 + 4
    # LR and loss_scale_factor, step by step (epoch 1: the P x K epoch)
    assert [s[:2] for s in t['steps']] == [s[:2] for s in j['steps']]
    assert [s[1] for s in t['steps']] == [0.0] * 4 + [1.0] * 2 + [0.0] * 4
    assert t['at'] == j['at']
    assert _indices(t) == _indices(j)
    assert t['corrections'] == j['corrections']
    assert [c[0] for c in t['corrections']] == [6]  # the epoch-2 LR step
    np.testing.assert_allclose(_losses(t)[0], _losses(j)[0], rtol=LOSS_RTOL)
    assert np.isfinite(_losses(t)).all()
    assert runs['port_names'] == runs['jax_names'] == [
        'model_epoch1.pkl', 'model_epoch3.pkl', 'model_final.pkl']
    assert sorted(runs['port_ckpts'], key=str) == \
        sorted(runs['jax_ckpts'], key=str) == [0, 2, 'final']


def test_preempt_resume_bitwise(runs, tmp_path, monkeypatch):
    """Preempted after 3 of epoch 0's 4 steps, then auto-resumed: every
    blob of model_final.pkl equals the continuous run's bit for bit, and
    the resumed run's first step trains on the continuous run's batch."""
    tc = tcfg.cfg
    both_cfgs(runs['opts'])
    out = str(tmp_path / 'pre')
    with pytest.raises(ttrain.Preempted) as ei:
        ttrain.train_model(tc, output_dir=out, decode_fn=runs['decode'],
                           num_workers=1, device='cpu',
                           preempt_event=AfterSteps(3))
    assert (ei.value.epoch, ei.value.step) == (0, 3)
    assert os.path.basename(ei.value.path) == 'model_preempt_epoch0_step3.pkl'
    monkeypatch.setenv('PPS_TPU_PROFILE_DIR', str(tmp_path / 'prof'))
    rec = _record(monkeypatch, tloader.ReIDLoader, tts, topt)
    ck = ttrain.train_model(tc, output_dir=out, decode_fn=runs['decode'],
                            num_workers=3, device='cpu')
    cont = runs['port']
    assert rec['at'] == cont['at'][3:]
    assert _indices(rec) == _indices(cont)[3:]
    assert _losses(rec) == _losses(cont)[3:]
    assert [(n + 3, f) for n, f in rec['corrections']] == cont['corrections']
    assert sorted(os.listdir(out)) == [
        'model_epoch1.pkl', 'model_epoch3.pkl', 'model_final.pkl',
        'model_preempt_epoch0_step3.pkl']
    got = load_object(ck['final'])['blobs']
    want = load_object(runs['port_ckpts']['final'])['blobs']
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # PPS_TPU_PROFILE_DIR: global steps [5, 15) traced
    assert os.path.getsize(str(tmp_path / 'prof' /
                               'train_steps.trace.json')) > 0
    # with model_final.pkl there, training is skipped
    again = ttrain.train_model(tc, output_dir=out, decode_fn=runs['decode'],
                               device='cpu')
    assert list(again) == ['final']


@pytest.mark.parametrize('names,want', [
    ([], (None, 0, 0)),
    (['model_epoch2.pkl', 'model_epoch10.pkl', 'notes.txt'],
     ('model_epoch10.pkl', 10, 0)),
    (['model_epoch3.pkl', 'model_preempt_epoch3_step7.pkl',
      'model_preempt_epoch2_step9.pkl'],
     ('model_preempt_epoch3_step7.pkl', 3, 7)),
    (['model_epoch4.pkl', 'model_preempt_epoch3_step7.pkl'],
     ('model_epoch4.pkl', 4, 0)),
    (['model_epoch5.orbax', 'model_epoch4.pkl'], ('model_epoch5.orbax', 5, 0)),
    (['model_epoch4.pkl', 'model_final.pkl'], ('model_final.pkl', -1, 0)),
])
def test_find_resume_checkpoint_matches(tmp_path, names, want):
    for n in names:
        (tmp_path / n).write_bytes(b'')
    got = tckpt.find_resume_checkpoint(str(tmp_path))
    assert got == jckpt.find_resume_checkpoint(str(tmp_path))
    path = None if want[0] is None else str(tmp_path / want[0])
    assert got == (path,) + want[1:]
    assert tckpt.find_resume_checkpoint(str(tmp_path / 'absent')) == \
        (None, 0, 0)


def test_sigterm_preempts_and_restores_handler(runs, tmp_path):
    tc = tcfg.cfg
    both_cfgs(runs['opts'])

    def outer(signum, frame):  # must not fire
        raise AssertionError('SIGTERM reached the outer handler')
    old = signal.signal(signal.SIGTERM, outer)
    try:
        def fire_when_armed():
            while signal.getsignal(signal.SIGTERM) is not \
                    ttrain.request_preemption:
                time.sleep(0.01)
            os.kill(os.getpid(), signal.SIGTERM)
        w = threading.Thread(target=fire_when_armed, daemon=True)
        w.start()
        with pytest.raises(ttrain.Preempted) as ei:
            ttrain.train_model(tc, output_dir=str(tmp_path),
                               decode_fn=runs['decode'], num_workers=1,
                               device='cpu')
        w.join(timeout=10)
        assert not w.is_alive()
        assert os.path.exists(ei.value.path)
        assert signal.getsignal(signal.SIGTERM) is outer
    finally:
        signal.signal(signal.SIGTERM, old)


def test_nan_loss_aborts(runs, tmp_path):
    """A NaN in the weights: the first logged line raises, and no
    snapshot or final checkpoint is written."""
    blobs = load_object(str(runs['root'] / 'weights.pkl'))
    blobs['blobs']['conv1_w'] = blobs['blobs']['conv1_w'] * np.nan
    bad = str(tmp_path / 'nan.pkl')
    from pps_tpu_torch.utils.io import save_object
    save_object(blobs, bad)
    tc = tcfg.cfg
    both_cfgs(runs['opts'] + ['TRAIN.WEIGHTS', bad])
    out = str(tmp_path / 'out')
    with pytest.raises(FloatingPointError, match='NaN'):
        ttrain.train_model(tc, output_dir=out, decode_fn=runs['decode'],
                           num_workers=1, device='cpu')
    assert os.listdir(out) == []


def test_unported_options_raise(runs, tmp_path, monkeypatch):
    """What the port still refuses.  (The host chain is ported: slice 3b;
    NUM_GPUS > 1 and a process group: slice 8; the model axis,
    TPU.CKPT_FORMAT orbax and PPS_TPU_DUMP_JAXPR: slice 9,
    tests/test_torch_port_model_axis.py, test_torch_port_ckpt_sharded.py,
    test_torch_port_graph_dump.py.)  A model axis of 2 needs two ranks;
    pps_tpu's .orbax directories cannot be read without orbax, and the
    message names pkl, the format both packages read."""
    tc = tcfg.cfg
    tcfg.reset_cfg()
    both_cfgs(runs['opts'] + ['TPU.MESH_SHAPE', '(-1, 2)'])
    with pytest.raises(ValueError, match='model axis of 2'):
        ttrain.train_model(tc, output_dir=str(tmp_path), device='cpu')
    tcfg.reset_cfg()
    both_cfgs(runs['opts'])
    (tmp_path / 'model_epoch1.orbax').mkdir()
    with pytest.raises(ValueError, match='pkl is the format both'):
        ttrain.train_model(tc, output_dir=str(tmp_path), device='cpu')


def test_step_seed_is_a_function_of_the_step():
    a = [ttrain.step_seed(12, s) for s in range(4)]
    assert a == [ttrain.step_seed(12, s) for s in range(4)]
    assert len(set(a)) == 4 and ttrain.step_seed(13, 0) != a[0]
    g = torch.Generator().manual_seed(a[3])  # a valid torch seed
    assert g.initial_seed() == a[3]


def _write_market(root, n_ids=4):
    """<root>/market1501/{trainval,test}.json and PNG-encoded images under
    .jpg names, the layout PPS_TPU_DATA_DIR points the catalog at."""
    import cv2
    base = root / 'market1501'
    dec = decoder(RAW_HW)
    for split, per_id, marks in (('trainval', 2, False), ('test', 3, True)):
        imdir, ann = write_coco(base, split, n_ids, per_id, hw=RAW_HW,
                                with_marks=marks)
        with open(ann) as f:
            for im in json.load(f)['images']:
                ok, buf = cv2.imencode('.png', dec(im['file_name']))
                assert ok
                (Path(imdir) / im['file_name']).write_bytes(buf.tobytes())


def test_cli_train_net_on_cpu(tmp_path):
    """``python -m pps_tpu_torch.tools.train_net --device cpu`` on the
    flagship yaml cut to a tiny size: trains, snapshots, tests."""
    _write_market(tmp_path / 'data')
    out = tmp_path / 'out'
    cmd = [sys.executable, '-m', 'pps_tpu_torch.tools.train_net',
           '--device', 'cpu',
           '--cfg', str(REPO / 'configs/market1501/pps_crm_triplet_R-50_1x.yaml'),
           'MODEL.NUM_CLASSES', '5', 'MODEL.DTYPE', 'float32',
           'TRAIN.WEIGHTS', "''", 'TRAIN.IMS_PER_BATCH', '8',
           'REID.P', '4', 'REID.K', '2', 'REID.SCALE', '(32, 96)',
           'SOLVER.MAX_ITER', '1', 'TEST.IMS_PER_BATCH', '8',
           'DATA_LOADER.NUM_THREADS', '2', 'OUTPUT_DIR', str(out)]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS='2',
               PPS_TPU_DATA_DIR=str(tmp_path / 'data'))
    r = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    train_dir = out / 'train' / 'market1501_trainval'
    assert sorted(os.listdir(str(train_dir))) == ['model_epoch1.pkl',
                                                  'model_final.pkl']
    assert (out / 'test' / 'market1501_test' / 'features.pkl').exists()
    assert 'json_stats: ' in r.stdout
    assert r.stdout.count('Single Query:') == 2  # final, then epoch 1


def test_cli_exits_75_when_preempted(monkeypatch):
    from pps_tpu_torch.tools import train_net

    def preempted(cfg, device=None):
        raise ttrain.Preempted(0, 3, 'model_preempt_epoch0_step3.pkl')
    monkeypatch.setattr(ttrain, 'train_model', preempted)
    monkeypatch.setattr('pps_tpu_torch.utils.logging.setup_logging',
                        lambda name: __import__('logging').getLogger(name))
    with pytest.raises(SystemExit) as ei:
        train_net.main(['--device', 'cpu', 'MODEL.TYPE', 'generalized_reid',
                        'MODEL.NUM_CLASSES', '5'])
    assert ei.value.code == 75
