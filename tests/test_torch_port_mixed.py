"""Mixed-size datasets in the port against pps_tpu, on the same inputs:
the padded device preprocessing, the padded minibatch wire (bitwise),
``ReIDLoader``'s wire decision and pad bucket, ``stream_extract``'s three
batch kinds with and without flip TTA, the stacked extraction's mixed-size
branch, and ``QueryEmbedder`` on mixed-size groups.  The synthetic
mixed-size datasets of the other driver tests come from ``write_mixed``
and ``mixed_decoder`` here."""

import json
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_cfg
from pps_tpu.data import device_preprocess as jpre
from pps_tpu.data import loader as jloader
from pps_tpu.data import minibatch as jminibatch
from pps_tpu.engine import serving as jserv
from pps_tpu.engine import test as jtest_engine
from pps_tpu.models.model import build_model as jbuild
from pps_tpu.parallel import mesh as mesh_lib
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.data import device_preprocess as tpre
from pps_tpu_torch.data import loader as tloader
from pps_tpu_torch.data import minibatch as tminibatch
from pps_tpu_torch.engine import serving as tserv
from pps_tpu_torch.engine import test as ttest_engine
from pps_tpu_torch.engine.checkpoint import params_from_numpy
from pps_tpu_torch.flagship import flagship_cfg
from pps_tpu_torch.models.model import build_model as tbuild

from test_torch_port_data import LOADER_OPTS, both_cfgs, write_coco

MEANS = np.array([[[102.9801, 115.9465, 122.7717]]])
# (H, W) decode sizes in a 48 x 20 bucket: pads of 0, 1, 2 and >= 3 px
SIZES = [(48, 20), (47, 19), (46, 18), (40, 16), (48, 17), (44, 20),
         (36, 14), (47, 20)]
BUCKET = (48, 20)
# resize products summed in another order on the two sides: partial sums
# of |x| <= 255 with the Keys weights, a few float32 ulps of ~300
RESIZE_ATOL = 1e-4
# the padded matrices are built in float32 from each sample's size (as
# pps_tpu builds them), cv2's exact-size ones in float64: the float32
# source position (o + 0.5) * h / 96 - 0.5 is off by up to ~2^-24 * 48,
# which the Keys weights' slope (<= 1.5) carries into 16 taps over a 255
# range: measured 1.06e-3 (pps_tpu's own test of this uses 1e-3)
EXACT_SIZE_ATOL = 2e-3
# features from the same weights through 53 float32 convs, sums in
# another order (tests/test_torch_port_model.py's bound); unit-norm rows
FEAT_ATOL = 1e-4


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


def size_of(iid, sizes=SIZES):
    """The decode size of image ``iid``: the sizes in turn."""
    return sizes[(iid - 1) % len(sizes)]


def mixed_decoder(sizes=SIZES):
    """decode_fn(path) -> uint8 [h, w, 3] of ``size_of(image id)``, from the
    file name alone: 8x4 colour blocks seeded by the identity, upsampled
    to the image's size, plus noise seeded by the image."""
    def decode(path):
        base = os.path.basename(path)
        pid = int(base[:8])
        iid = int(base.split('_')[-1].split('.')[0])
        h, w = size_of(iid, sizes)
        blocks = np.random.RandomState(pid).randint(
            0, 255, size=(8, 4, 3)).astype(np.float32)
        rows = np.arange(h) * 8 // h
        cols = np.arange(w) * 4 // w
        im = blocks[rows][:, cols]
        im += np.random.RandomState(iid).randn(h, w, 3) * 8.0
        return np.clip(im, 0, 255).astype(np.uint8)
    return decode


def write_mixed(root, split, n_ids, per_id, sizes=SIZES, with_marks=False,
                n_cams=2, metadata=True):
    """``write_coco`` with each image's height/width set to its decode
    size (or removed, ``metadata=False``); returns (image dir, json)."""
    imdir, ann = write_coco(root, split, n_ids, per_id,
                            with_marks=with_marks, n_cams=n_cams)
    with open(ann) as f:
        raw = json.load(f)
    for im in raw['images']:
        h, w = size_of(im['id'], sizes)
        if metadata:
            im['height'], im['width'] = h, w
        else:
            del im['height'], im['width']
    with open(ann, 'w') as f:
        json.dump(raw, f)
    return imdir, ann


# ---------------------------------------------------------------------------
# padded preprocessing and the padded minibatch wire
# ---------------------------------------------------------------------------


def _padded(ims, bucket=BUCKET):
    return np.stack([np.pad(im, ((0, bucket[0] - im.shape[0]),
                                 (0, bucket[1] - im.shape[1]), (0, 0)),
                            mode='reflect') for im in ims])


def test_preprocess_padded_matches():
    rng = np.random.RandomState(0)
    ims = [rng.randint(0, 256, s + (3,)).astype(np.uint8) for s in SIZES]
    padded, valid = _padded(ims), np.asarray(SIZES, np.int32)
    want = np.asarray(jpre.preprocess_on_device_padded(
        jnp.asarray(padded), jnp.asarray(valid), MEANS, (96, 32)))
    got = tpre.preprocess_on_device_padded(
        torch.tensor(padded), torch.tensor(valid), MEANS, (96, 32)).numpy()
    assert got.shape == want.shape == (len(SIZES), 96, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)
    # each sample as if resized from its true size (cv2's matrices)
    for i, im in enumerate(ims):
        one = tpre.preprocess_on_device(torch.tensor(im[None]), MEANS,
                                        (96, 32)).numpy()[0]
        np.testing.assert_allclose(got[i], one, rtol=0,
                                   atol=EXACT_SIZE_ATOL)


def _entries(n=8):
    """roidb-like entries of images 1..n, every other one flipped."""
    return [{'image': '{:08d}_0001_{:08d}.jpg'.format(i % 3 + 1, i),
             'gt_class': i % 3 + 1, 'flipped': i % 2 == 0}
            for i in range(1, n + 1)]


def test_minibatch_padded_wire_bitwise():
    jc, tc = both_cfgs(LOADER_OPTS)
    dec = mixed_decoder()
    entries = _entries()
    want = jminibatch.get_minibatch(entries, jc, np.random.RandomState(0),
                                    train=True, decode_fn=dec, raw=True,
                                    raw_pad_hw=BUCKET)
    got = tminibatch.get_minibatch(entries, tc, decode_fn=dec,
                                   raw_pad_hw=BUCKET)
    assert sorted(got) == sorted(want) == [
        'data_u8', 'flipped', 'labels_int32', 'labels_oh', 'valid_hw']
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got['valid_hw'], SIZES)
    # a decode larger than the bucket: the host chain, the same bytes
    small = (40, 20)
    want = jminibatch.get_minibatch(entries, jc, np.random.RandomState(1),
                                    train=True, decode_fn=dec, raw=True,
                                    raw_pad_hw=small)
    got = tminibatch.get_minibatch(entries, tc, decode_fn=dec,
                                   raw_pad_hw=small,
                                   rng=np.random.RandomState(1))
    assert sorted(got) == ['data', 'labels_int32', 'labels_oh']
    np.testing.assert_array_equal(got['data'], want['data'])


@pytest.mark.parametrize('kind', ['uniform', 'mixed', 'bare'])
def test_loader_wire_and_bucket_match(tmp_path, kind, caplog):
    """The wire decided from metadata, as pps_tpu decides it, and the first
    epoch's batches bitwise equal to pps_tpu's."""
    from pps_tpu.data import catalog as jcatalog
    from pps_tpu.data import json_dataset as jjson
    from pps_tpu_torch.data import catalog as tcatalog
    from pps_tpu_torch.data import json_dataset as tjson
    sizes = [(48, 20)] if kind == 'uniform' else SIZES
    imdir, ann = write_mixed(tmp_path, 'trainval', 6, 4, sizes=sizes,
                             metadata=kind != 'bare', n_cams=3)
    name = 'port_mixed_' + kind
    for cat in (jcatalog, tcatalog):
        cat.register_dataset(name, imdir, ann)
    jr, _ = jjson.combined_roidb_for_training(name)
    tr, _ = tjson.combined_roidb_for_training(name)
    jc, tc = both_cfgs(LOADER_OPTS)
    dec = mixed_decoder(sizes)
    j = jloader.ReIDLoader(jr, jc, num_workers=2, decode_fn=dec, raw=True)
    with caplog.at_level(logging.INFO, logger='pps_tpu_torch'):
        t = tloader.ReIDLoader(tr, tc, num_workers=2, decode_fn=dec)
    assert (t._raw, t._raw_pad_hw) == (j._raw, j._raw_pad_hw)
    assert t._raw_pad_hw == (BUCKET if kind == 'mixed' else None)
    assert t._raw == (kind != 'bare')
    assert ('host chain' in caplog.text) == (kind == 'bare')
    want = list(j.iter_epoch(0))
    got = list(t.iter_epoch(0))
    assert len(got) == len(want) == t.schedule.ipe
    keys = {'uniform': 'data_u8', 'mixed': 'valid_hw', 'bare': 'data'}[kind]
    for (gi, gs, g), (wi, ws, w) in zip(got, want):
        assert (gi, gs) == (wi, ws) and keys in g
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ---------------------------------------------------------------------------
# extraction and serving on mixed sizes, from pps_tpu's weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def models():
    """pps_tpu's model (float32, 96x32) with non-trivial eval BN stats and
    the port's from the same numbers."""
    jcfg = _flagship_cfg(scale=(32, 96), num_classes=11, dtype='float32')
    jm = jbuild(jcfg)
    # numpy weights of pps_tpu's shapes (its jitted init alone takes ~12 s
    # here): He-scaled convs (HWIO), BN scales near 1, small biases
    shapes, state_shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(2))
    rng = np.random.RandomState(2)
    jp = {}
    for k, v in sorted(shapes.items()):
        if k.endswith('_s'):
            a = 1.0 + 0.1 * rng.randn(*v.shape)
        elif k.endswith('_b'):
            a = 0.1 * rng.randn(*v.shape)
        else:
            fan_in = int(np.prod(v.shape[:-1])) // (
                v.shape[0] if v.ndim == 3 else 1)
            a = rng.randn(*v.shape) * np.sqrt(2.0 / fan_in)
        jp[k] = a.astype(np.float32)
    js = {k: (rng.randn(*v.shape) * 0.1 if k.endswith('_rm')
              else rng.rand(*v.shape) + 0.5).astype(np.float32)
          for k, v in sorted(state_shapes.items())}
    tcfg_ = flagship_cfg(scale=(32, 96), num_classes=11, dtype='float32')
    tm = tbuild(tcfg_, device='cpu')
    tp, ts = params_from_numpy(tm, jp, js)
    return {'jm': jm, 'jp': jp, 'js': js, 'tm': tm, 'tp': tp, 'ts': ts,
            'mesh': mesh_lib.build_mesh(jcfg, mesh_shape=(1, 1))}


def _roidb(n, metadata=True, sizes=SIZES):
    out = []
    for i in range(1, n + 1):
        h, w = size_of(i, sizes)
        e = {'image': '{:08d}_0001_{:08d}.jpg'.format(i % 4 + 1, i)}
        if metadata:
            e.update(height=h, width=w)
        out.append(e)
    return out


# batches of 8 over 20 images without metadata: the first batch uniform
# (the pinned uint8 shape), the second mixed, the third (a tail of 4)
# uniform in another shape: 'u8', 'f32', 'f32'
BARE_SIZES = [(48, 20)] * 8 + SIZES + [(44, 16)] * 4

CASES = [
    # (roidb, flip_tta, device_preproc, kinds)
    ('meta', True, True, {'u8p': 3, 'u8': 0, 'f32': 0}),
    ('bare', False, True, {'u8p': 0, 'u8': 1, 'f32': 2}),
    ('meta', True, False, {'u8p': 0, 'u8': 0, 'f32': 3}),
]


@pytest.mark.parametrize('which,flip,preproc,kinds', CASES)
def test_stream_extract_kinds_match(models, caplog, which, flip, preproc,
                                    kinds):
    m = models
    sizes = SIZES if which == 'meta' else BARE_SIZES
    roidb = _roidb(20, metadata=which == 'meta', sizes=sizes)
    dec = mixed_decoder(sizes)
    cfg = tcfg.cfg
    jc = _flagship_cfg(scale=(32, 96), num_classes=11, dtype='float32')
    with m['mesh']:
        want = jtest_engine.stream_extract(
            jc, m['jm'], m['jp'], m['js'], roidb, 8, m['mesh'],
            decode_fn=dec, flip_tta=flip, device_preproc=preproc)
    flagship_cfg(scale=(32, 96), num_classes=11, dtype='float32')
    with caplog.at_level(logging.INFO, logger='pps_tpu_torch'):
        got = ttest_engine.stream_extract(
            cfg, m['tm'], m['tp'], m['ts'], roidb, 8, decode_fn=dec,
            flip_tta=flip, device_preproc=preproc)
    assert got.shape == want.shape == (20, 3968)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_ATOL)
    line = [r.getMessage() for r in caplog.records
            if 'batch kinds' in r.getMessage()][-1]
    assert json.loads(line.split('batch kinds: ')[1]) == kinds


def test_stacked_extraction_mixed_branch_matches(models):
    """streaming=False on a mixed-size set: host preprocessing (float32)
    on both sides, without decoding a uint8 stack first."""
    m = models
    roidb = _roidb(12)
    dec = mixed_decoder()
    jc = _flagship_cfg(scale=(32, 96), num_classes=11, dtype='float32')
    want = jtest_engine.extract_dataset_features(
        jc, m['jm'], m['jp'], m['js'], roidb, decode_fn=dec, batch_size=8,
        mesh=m['mesh'], streaming=False)
    tc = flagship_cfg(scale=(32, 96), num_classes=11, dtype='float32')
    got = ttest_engine.extract_dataset_features(
        tc, m['tm'], m['tp'], m['ts'], roidb, decode_fn=dec, batch_size=8,
        streaming=False)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_ATOL)
    assert ttest_engine.decode_uint8_stack(roidb, decode_fn=dec) is None


def test_query_embedder_mixed_group_matches(models):
    """A mixed-size group is preprocessed on the host on both sides; a
    uniform group of the pinned size rides the uint8 wire; another uniform
    size, after the pin, the float32 one."""
    m = models
    dec = mixed_decoder()
    jc = _flagship_cfg(scale=(32, 96), num_classes=11, dtype='float32')
    jq = jserv.QueryEmbedder(jc, m['jm'], m['jp'], m['js'], m['mesh'],
                             max_batch=4)
    tc = flagship_cfg(scale=(32, 96), num_classes=11, dtype='float32')
    tq = tserv.QueryEmbedder(tc, m['tm'], m['tp'], m['ts'], max_batch=4,
                             device='cpu')
    paths = ['{:08d}_0001_{:08d}.jpg'.format(1, i) for i in range(1, 9)]
    groups = [paths[1:4],              # mixed: host preprocessing
              [paths[0], paths[7]],    # 48x20 and 47x20: mixed again
              [paths[0]],              # 48x20: pins the uint8 wire
              [paths[2]]]              # 46x18 after the pin: host path
    for g in groups:
        with m['mesh']:
            want = jq.embed(g, decode_fn=dec)
        got = tq.embed(g, dec)
        assert got.shape == want.shape == (len(g), 3968)
        np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_ATOL)
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0,
                                   atol=1e-5)
    assert tq._u8_shape == jq._u8_shape == (48, 20, 3)
    # a warmed embedder pins the warmed size
    tq2 = tserv.QueryEmbedder(tc, m['tm'], m['tp'], m['ts'], max_batch=4,
                              device='cpu')
    tq2.warmup(raw_hw=(46, 18))
    assert tq2._u8_shape == (46, 18, 3)
