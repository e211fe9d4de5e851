"""The port's host augmentation chain against pps_tpu's: each op of
``data/transforms.py``, ``augment`` and ``prep_im_for_blob``, the host
chain of ``get_minibatch`` (train and test), and ``ReIDLoader`` with
``TPU.DEVICE_AUGMENT False``: the same ``RandomState`` seed gives the same
bytes (numpy + cv2 on both sides).  Then ``TPU.WIRE_DTYPE bfloat16``: the
loader casts the float32 wire on the host, as pps_tpu's ``device_put_fn``
does, and ``train_model`` feeds those batches straight to the model."""

import os
import shutil
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pps_tpu.data import loader as jloader
from pps_tpu.data import minibatch as jminibatch
from pps_tpu.data import transforms as jtr
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.data import loader as tloader
from pps_tpu_torch.data import minibatch as tminibatch
from pps_tpu_torch.data import transforms as ttr
from pps_tpu_torch.engine import train as ttrain
from pps_tpu_torch.parallel import mesh as tmesh
from pps_tpu_torch.parallel import train_step as tts

from test_torch_port_data import LOADER_OPTS, both_cfgs, decoder, toy  # noqa

MEANS = np.array([[[102.9801, 115.9465, 122.7717]]])
# every op of the chain on, at the reference's usual ranges
AUG_OPTS = ['REID.CROP_PROB', '0.5', 'REID.CROP_RATIO', '0.8',
            'REID.HORIZONTAL_CROP_PROB', '0.5',
            'REID.HORIZONTAL_CROP_RATIO', '0.8',
            'REID.HSV_JITTER_PROB', '0.5', 'REID.SATURATION_RANGE', '40',
            'REID.HUE_RANGE', '10', 'REID.VALUE_RANGE', '40',
            'REID.GAUSSIAN_BLUR_PROB', '0.5',
            'REID.GAUSSIAN_BLUR_KERNEL', '7',
            'REID.RANDOM_ERASING_PROB', '0.5']


@pytest.fixture
def tmp_path(tmp_path):
    """A test's checkpoints are freed when it ends (pytest keeps every
    test's directory until the session ends)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


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


def _img(seed, h=64, w=32):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)


def _same_stream(a, b):
    """Both RandomStates are at the same point of their stream."""
    return np.array_equal(a.get_state()[1], b.get_state()[1]) and \
        a.get_state()[2] == b.get_state()[2]


OPS = [
    ('random_crop', (0.7, 0.75)),
    ('horizontal_crop', (0.9, 0.7)),
    ('hsv_jitter', (0.8, 40, 10, 40)),
    ('gaussian_blur', (0.8, 7)),
    ('random_erasing', (0.8, MEANS)),
]


@pytest.mark.parametrize('name,args', OPS, ids=[o[0] for o in OPS])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_each_op_bitwise(name, args, seed):
    im = _img(seed + 40)
    rj, rt = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(4):  # four draws in a row: the streams stay together
        want = getattr(jtr, name)(im, rj, *args)
        got = getattr(ttr, name)(im, rt, *args)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert _same_stream(rt, rj)


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_augment_and_prep_bitwise(seed):
    jc, tc = both_cfgs(['REID.SCALE', '(32, 96)'] + AUG_OPTS)
    im = _img(seed, 70, 30)
    rj, rt = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(3):
        want = jtr.augment(im, rj, jc)
        got = ttr.augment(im, rt, tc)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            ttr.prep_im_for_blob(got, MEANS, (32, 96)),
            jtr.prep_im_for_blob(want, MEANS, (32, 96)))
    assert _same_stream(rt, rj)


def test_ops_validate_probabilities():
    rng = np.random.RandomState(0)
    with pytest.raises(ValueError):
        ttr.random_crop(_img(0), rng, 1.5, 0.8)
    with pytest.raises(ValueError):
        ttr.random_crop(_img(0), rng, 1.0, 1.0)
    with pytest.raises(ValueError):
        ttr.hsv_jitter(_img(0), rng, -0.1, 1, 1, 1)


@pytest.mark.parametrize('train', [True, False])
def test_minibatch_host_chain_bitwise(toy, train):  # noqa: F811
    jr, tr = toy
    jc, tc = both_cfgs(LOADER_OPTS + AUG_OPTS)
    dec = decoder((48, 20))
    idx = [0, 5, 30, 7, 44, 2, 25, 13]
    want = jminibatch.get_minibatch([jr[i] for i in idx], jc,
                                    np.random.RandomState(3), train=train,
                                    decode_fn=dec, raw=False)
    got = tminibatch.get_minibatch([tr[i] for i in idx], tc, train=train,
                                   decode_fn=dec, raw=False,
                                   rng=np.random.RandomState(3))
    assert sorted(got) == sorted(want) == ['data', 'labels_int32',
                                           'labels_oh']
    assert got['data'].shape == (8, 96, 32, 3)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if train:
        with pytest.raises(ValueError, match='rng'):
            tminibatch.get_minibatch([tr[0]], tc, decode_fn=dec, raw=False)


def test_loader_host_chain_matches(toy):  # noqa: F811
    """TPU.DEVICE_AUGMENT False: the first 3 batches bitwise equal to
    pps_tpu's, with 1 and 3 workers (the draws are keyed by the step)."""
    jr, tr = toy
    jc, tc = both_cfgs(LOADER_OPTS + AUG_OPTS)
    dec = decoder((48, 20))
    j = jloader.ReIDLoader(jr, jc, num_workers=2, decode_fn=dec, raw=False)
    want = [b for _, _, b in j.iter_epoch(0)][:3]
    for workers in (1, 3):
        t = tloader.ReIDLoader(tr, tc, num_workers=workers, decode_fn=dec,
                               raw=False)
        got = [b for _, _, b in t.iter_epoch(0)][:3]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w) == ['data', 'labels_int32',
                                              'labels_oh']
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _rank_mesh(rank, world):
    """Rank ``rank`` of a ``world``-rank data mesh, for the loader alone:
    it reads only its rows, so no process group is needed."""
    m = tmesh.Mesh(np.arange(world).astype(object).reshape(world, 1),
                   ('data', 'model'), torch.device('cpu'))
    m.group, m.rank, m.world_size = 'a stand-in group', rank, world
    return m


@pytest.mark.parametrize('metadata', [True, False], ids=['hw', 'no_hw'])
def test_loader_host_chain_over_ranks(toy, metadata):  # noqa: F811
    """Over a 2-rank data mesh the host chain takes the global batch's
    draws in plan order: the ranks' rows put together are pps_tpu's global
    batch bitwise, for decodes of mixed sizes (a row's draws depend on
    its shape).  With height/width metadata a rank decodes only its own
    rows."""
    jr, tr = toy
    world = 2
    jc, tc = both_cfgs(LOADER_OPTS + AUG_OPTS + [
        'TRAIN.IMS_PER_BATCH', '4', 'REID.P', '2', 'NUM_GPUS', str(world)])
    dec = decoder((48, 20))

    def height(path):
        return 36 + zlib.crc32(os.path.basename(path).encode()) % 13

    def mixed(path):
        return dec(path)[:height(path)]
    roidbs = []
    for r in (jr, tr):
        r = [dict(e) for e in r]
        for e in r:
            e.pop('height', None)
            e.pop('width', None)
            if metadata:
                e['height'], e['width'] = height(e['image']), 20
        roidbs.append(r)
    j = jloader.ReIDLoader(roidbs[0], jc, num_workers=2, decode_fn=mixed,
                           raw=False)
    want = [b for _, _, b in j.iter_epoch(0)]
    got, decoded = [], []
    for rank in range(world):
        seen = []

        def counted(path):
            seen.append(path)
            return mixed(path)
        t = tloader.ReIDLoader(roidbs[1], tc, num_workers=2,
                               decode_fn=counted, raw=False,
                               mesh=_rank_mesh(rank, world))
        got.append([b for _, _, b in t.iter_epoch(0)])
        decoded.append(len(seen))
    n = len(want)
    assert n >= 3 and len(got[0]) == len(got[1]) == n
    for s, w in enumerate(want):
        assert w['data'].shape[0] == 8
        for k in w:
            np.testing.assert_array_equal(
                np.concatenate([got[r][s][k] for r in range(world)]), w[k],
                err_msg='{} of batch {}'.format(k, s))
    # with the sizes in the metadata each rank decodes its 4 rows of a
    # batch; without them rank 1 decodes rank 0's rows too, for shapes
    assert decoded == ([4 * n, 4 * n] if metadata else [4 * n, 8 * n])


def test_loader_bf16_wire_matches(toy):  # noqa: F811
    """wire_dtype bfloat16: 'data' crosses as bfloat16, rounded as pps_tpu
    rounds it (to nearest even, both sides)."""
    jr, tr = toy
    jc, tc = both_cfgs(LOADER_OPTS + AUG_OPTS)
    dec = decoder((48, 20))
    j = jloader.ReIDLoader(jr, jc, num_workers=1, decode_fn=dec, raw=False,
                           device_put_fn=lambda b: dict(
                               b, data=jnp.bfloat16(b['data'])))
    want = next(iter(j.iter_epoch(0)))[2]
    t = tloader.ReIDLoader(tr, tc, num_workers=1, decode_fn=dec, raw=False,
                           device='cpu', wire_dtype='bfloat16')
    got = next(iter(t.iter_epoch(0)))[2]
    assert got['data'].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got['data'].float().numpy(),
        np.asarray(want['data']).astype(np.float32))
    with pytest.raises(ValueError, match='wire_dtype'):
        tloader.ReIDLoader(tr, tc, wire_dtype='float16')


def test_train_model_host_chain_bf16(toy, tmp_path, monkeypatch):  # noqa
    """train_model with TPU.DEVICE_AUGMENT False and TPU.WIRE_DTYPE
    bfloat16 on a tiny model: every step gets a bfloat16 'data' batch and
    the loss is finite."""
    _, tr = toy
    opts = ['MODEL.TYPE', 'generalized_reid',
            'MODEL.CONV_BODY', 'ResNet.add_ResNet50_conv5_body',
            'MODEL.DTYPE', 'float32', 'MODEL.USE_BN', 'True',
            'FAST_RCNN.ROI_BOX_HEAD', 'pps_heads.add_pps_part_head',
            'RESNETS.RES5_STRIDE', '1', 'REID.BPM_STRIP_NUM', '5',
            'REID.BPM_DIM', '16', 'REID.CRM', 'True',
            'REID.NORMALIZE_FEATURE', 'True', 'TRAIN.SNAPSHOT_ITERS', '1',
            'SOLVER.BASE_LR', '0.001', 'TPU.DEVICE_AUGMENT', 'False',
            'TPU.WIRE_DTYPE', 'bfloat16']
    _, tc = both_cfgs(LOADER_OPTS + AUG_OPTS + opts + ['SOLVER.MAX_ITER',
                                                       '1'])
    seen = []
    make = tts.make_train_step

    def recorded(*a, **k):
        step = make(*a, **k)

        def run(ts, batch, *rest, **kw):
            seen.append((sorted(batch), batch.get('data',
                                                  torch.zeros(1)).dtype))
            out = step(ts, batch, *rest, **kw)
            seen[-1] += (float(out[1]['loss']),)
            return out
        return run
    monkeypatch.setattr(tts, 'make_train_step', recorded)
    ckpts = ttrain.train_model(tc, output_dir=str(tmp_path), roidb=tr,
                               decode_fn=decoder((48, 20)), num_workers=2,
                               device='cpu')
    assert 'final' in ckpts and len(seen) == 6
    for keys, dtype, loss in seen:
        assert keys == ['data', 'labels_int32', 'labels_oh']
        assert dtype == torch.bfloat16 and np.isfinite(loss)
