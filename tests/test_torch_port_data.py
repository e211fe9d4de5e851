"""The port's data pipeline against pps_tpu's on the same inputs: the
catalog and roidb, the sampler index streams and the epoch schedule
(identical), raw uint8 minibatches (bitwise), and ``ReIDLoader``'s plans
and yielded batches with 1 and 4 workers and on a mid-epoch resume
(identical).  The helpers ``write_coco`` and ``decoder`` make the
synthetic datasets of the other ``test_torch_port_*`` driver tests."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from pps_tpu import config as jconfig
from pps_tpu.data import catalog as jcatalog
from pps_tpu.data import json_dataset as jjson
from pps_tpu.data import loader as jloader
from pps_tpu.data import minibatch as jminibatch
from pps_tpu.data import sampler as jsampler
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.data import catalog as tcatalog
from pps_tpu_torch.data import json_dataset as tjson
from pps_tpu_torch.data import loader as tloader
from pps_tpu_torch.data import minibatch as tminibatch
from pps_tpu_torch.data import sampler as tsampler
from pps_tpu_torch.data import transforms as ttransforms
from pps_tpu_torch.device import Transfer

from _torch_port_dist import decoder  # noqa: F401 (other modules import it)


def write_coco(root, split, n_ids, per_id, hw=(96, 32), with_marks=False,
               n_cams=2):
    """A COCO-style re-ID json with Market-style file names
    (``{id:08d}_{cam:04d}_{image:08d}.jpg``); returns (image dir, json).
    With marks: per identity, the first image is a query and the rest are
    gallery."""
    imdir = os.path.join(str(root), 'images')
    os.makedirs(imdir, exist_ok=True)
    images, annotations, categories = [], [], []
    for pid in range(1, n_ids + 1):
        categories.append({'id': pid, 'name': '{:08d}'.format(pid)})
        for j in range(per_id):
            iid = len(images) + 1
            name = '{:08d}_{:04d}_{:08d}.jpg'.format(pid, j % n_cams + 1, iid)
            images.append({'id': iid, 'file_name': name,
                           'width': hw[1], 'height': hw[0]})
            ann = {'id': iid, 'image_id': iid, 'category_id': pid}
            if with_marks:
                ann['mark'] = 0 if j == 0 else 1
            annotations.append(ann)
    ann_fn = os.path.join(str(root), split + '.json')
    with open(ann_fn, 'w') as f:
        json.dump({'images': images, 'annotations': annotations,
                   'categories': categories}, f)
    return imdir, ann_fn


def both_cfgs(opts):
    """The same KEY VALUE list merged into pps_tpu's and the port's
    global cfg; returns (jax cfg, port cfg)."""
    jconfig.merge_cfg_from_list(opts)
    tcfg.merge_cfg_from_list(opts)
    return jconfig.cfg, tcfg.cfg


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


LOADER_OPTS = ['MODEL.NUM_CLASSES', '7', 'TRAIN.IMS_PER_BATCH', '8',
               'REID.SCALE', '(32, 96)', 'REID.TRIPLET_LOSS', 'True',
               'REID.TRIPLET_LOSS_CROSS', 'True',
               'REID.TRIPLET_LOSS_START', '0', 'REID.P', '4', 'REID.K', '2',
               'SOLVER.MAX_ITER', '4']


@pytest.fixture
def toy(tmp_path):
    """6 identities x 4 images (3 cameras), 48x20 decodes, registered in
    both catalogs; returns (jax roidb, port roidb)."""
    imdir, ann = write_coco(tmp_path, 'trainval', 6, 4, hw=(48, 20),
                            n_cams=3)
    jcatalog.register_dataset('port_toy', imdir, ann)
    tcatalog.register_dataset('port_toy', imdir, ann)
    jr, jn = jjson.combined_roidb_for_training('port_toy')
    tr, tn = tjson.combined_roidb_for_training('port_toy')
    assert jn == tn == 7
    return jr, tr


def test_catalog_matches():
    assert sorted(tcatalog.datasets()) == sorted(jcatalog.datasets())
    for name in jcatalog.datasets():
        assert tcatalog.get_im_dir(name) == jcatalog.get_im_dir(name)
        assert tcatalog.get_ann_fn(name) == jcatalog.get_ann_fn(name)
    assert tcatalog.contains('market1501_test')
    with pytest.raises(KeyError):
        tcatalog.get_im_dir('no_such_dataset')


@pytest.mark.parametrize('flipped', [True, False])
def test_roidb_matches(tmp_path, flipped):
    imdir, ann = write_coco(tmp_path, 'trainval', 5, 3)
    for cat in (jcatalog, tcatalog):
        cat.register_dataset('port_rdb', imdir, ann)
    jr, jn = jjson.combined_roidb_for_training(('port_rdb',),
                                               use_flipped=flipped)
    tr, tn = tjson.combined_roidb_for_training(('port_rdb',),
                                               use_flipped=flipped)
    assert (tn, len(tr)) == (jn, len(jr)) == (6, 15 * (1 + flipped))
    assert tr == jr


def test_test_roidb_matches(tmp_path):
    imdir, ann = write_coco(tmp_path, 'test', 4, 3, with_marks=True)
    for cat in (jcatalog, tcatalog):
        cat.register_dataset('port_rdb_test', imdir, ann)
    got = tjson.roidb_for_test('port_rdb_test')
    assert got == jjson.roidb_for_test('port_rdb_test')
    assert [e['mark'] for e in got[:3]] == [0, 1, 1]
    assert len(tjson.ReIDDataset('port_rdb_test')) == 12


def test_roidb_refuses_two_annotations(tmp_path):
    imdir, ann = write_coco(tmp_path, 'bad', 2, 1)
    with open(ann) as f:
        raw = json.load(f)
    raw['annotations'].append(dict(raw['annotations'][0], id=99))
    with open(ann, 'w') as f:
        json.dump(raw, f)
    tcatalog.register_dataset('port_rdb_bad', imdir, ann)
    with pytest.raises(ValueError, match='one annotation'):
        tjson.ReIDDataset('port_rdb_bad')


@pytest.mark.parametrize('n,b,seed', [(32, 8, 3), (30, 8, 11), (7, 3, 0)])
def test_perm_sampler_stream_matches(n, b, seed):
    j = jsampler.PermSampler(n, b, seed=seed)
    t = tsampler.PermSampler(n, b, seed=seed)
    for _ in range(3 * n // b + 2):
        assert t.next_batch() == j.next_batch()


@pytest.mark.parametrize('p,k,per_id,seed', [(4, 2, 3, 4), (3, 4, 2, 12)])
def test_pk_sampler_stream_matches(p, k, per_id, seed):
    labels = np.repeat(np.arange(7), per_id)[::-1]
    j = jsampler.PKSampler(labels, p, k, seed=seed)
    t = tsampler.PKSampler(labels, p, k, seed=seed)
    assert t.num_classes == j.num_classes == 7
    for _ in range(8):
        assert t.next_batch() == j.next_batch()


@pytest.mark.parametrize('opts,n_images,n_ids', [
    (['REID.TRIPLET_LOSS', 'True', 'REID.TRIPLET_LOSS_CROSS', 'True',
      'REID.TRIPLET_LOSS_START', '2', 'SOLVER.MAX_ITER', '8'], 80, 12),
    (['REID.TRIPLET_LOSS', 'True', 'REID.TRIPLET_LOSS_CROSS', 'True',
      'REID.TRIPLET_LOSS_START', '0', 'SOLVER.MAX_ITER', '5'], 30, 3),
    (['REID.TRIPLET_LOSS', 'True', 'SOLVER.MAX_ITER', '3'], 80, 12),
    (['SOLVER.MAX_ITER', '3', 'NUM_GPUS', '2'], 80, 12),
])
def test_epoch_schedule_matches(opts, n_images, n_ids):
    jc, tc = both_cfgs(['TRAIN.IMS_PER_BATCH', '8', 'REID.P', '4',
                        'REID.K', '2'] + opts)
    j = jsampler.EpochSchedule(jc, n_images, n_ids)
    t = tsampler.EpochSchedule(tc, n_images, n_ids)
    for attr in ('global_batch', 'ipe', 'ipe_triplet', 'max_epoch'):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.total_steps() == j.total_steps()
    for ep in range(t.max_epoch + 1):
        assert t.is_triplet_epoch(ep) == j.is_triplet_epoch(ep)
        assert t.epoch_len(ep) == j.epoch_len(ep)
        assert t.steps_before_epoch(ep) == j.steps_before_epoch(ep)
        for i in (0, t.epoch_len(ep) - 1):
            assert t.describe(ep, i) == j.describe(ep, i)
            assert t.lr_iter(ep, i) == j.lr_iter(ep, i)


def test_raw_minibatch_bitwise(toy):
    jr, tr = toy
    jc, tc = both_cfgs(LOADER_OPTS)
    dec = decoder((48, 20))
    idx = [0, 5, 30, 7, 44, 2, 25, 13]  # originals and flipped entries
    want = jminibatch.get_minibatch([jr[i] for i in idx], jc,
                                    np.random.RandomState(0), train=True,
                                    decode_fn=dec, raw=True)
    got = tminibatch.get_minibatch([tr[i] for i in idx], tc, decode_fn=dec)
    assert sorted(got) == sorted(want) == ['data_u8', 'flipped',
                                           'labels_int32', 'labels_oh']
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_minibatch_unported_wires_raise(toy):
    """The wires that raised before slice 3b now give pps_tpu's batches:
    the padded wire, the host chain, and a mixed batch on the raw wire
    (which falls back to the host chain)."""
    jr, tr = toy
    jc, tc = both_cfgs(LOADER_OPTS)
    dec = decoder((48, 20))

    def mixed(path):
        return dec(path)[:(40 if path.endswith('1.jpg') else 48)]
    for kw in (dict(raw_pad_hw=(64, 32)), dict(raw=False),
               dict(decode_fn=mixed)):
        want = jminibatch.get_minibatch(
            jr[:2], jc, np.random.RandomState(0), train=True,
            decode_fn=kw.get('decode_fn', dec), raw=kw.get('raw', True),
            raw_pad_hw=kw.get('raw_pad_hw'))
        got = tminibatch.get_minibatch(
            tr[:2], tc, rng=np.random.RandomState(0),
            **dict(dict(decode_fn=dec), **kw))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _loader_batches(loader, ep, start=0):
    out = []
    for i, scale, batch in loader.iter_epoch(ep, start):
        out.append((i, scale, {k: np.array(v) for k, v in batch.items()}))
    return out


@pytest.mark.parametrize('workers', [1, 4])
def test_loader_matches(toy, workers):
    """Plans and yielded batches of epochs 0 (shuffled) and 1 (P x K)."""
    jr, tr = toy
    jc, tc = both_cfgs(LOADER_OPTS)
    dec = decoder((48, 20))
    j = jloader.ReIDLoader(jr, jc, num_workers=workers, prefetch=3,
                           decode_fn=dec, raw=True)
    t = tloader.ReIDLoader(tr, tc, num_workers=workers, prefetch=3,
                           decode_fn=dec)
    assert j.plan_epoch(0) == t.plan_epoch(0)
    for ep in (1, 2):
        want = _loader_batches(j, ep)
        got = _loader_batches(t, ep)
        assert [g[:2] for g in got] == [w[:2] for w in want]
        assert len(got) == t.schedule.epoch_len(ep) > 0
        for (_, _, g), (_, _, w) in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert 0 <= t.qsize() <= 3


def test_loader_midepoch_resume_matches(toy):
    """A loader that skips 2 epochs, then starts epoch 2 at step 1, yields
    what pps_tpu's does, and the tail a continuous loader yields."""
    jr, tr = toy
    jc, tc = both_cfgs(LOADER_OPTS)
    dec = decoder((48, 20))
    j = jloader.ReIDLoader(jr, jc, num_workers=2, decode_fn=dec, raw=True)
    j.skip_epochs(2)
    want = _loader_batches(j, 2, start=1)
    t = tloader.ReIDLoader(tr, tc, num_workers=2, decode_fn=dec)
    t.skip_epochs(2)
    got = _loader_batches(t, 2, start=1)
    cont = tloader.ReIDLoader(tr, tc, num_workers=3, decode_fn=dec)
    for ep in range(2):
        _loader_batches(cont, ep)
    tail = _loader_batches(cont, 2)[1:]
    assert len(got) == len(want) == len(tail) == t.schedule.ipe - 1
    for (gi, gs, g), (wi, ws, w), (ci, _, c) in zip(got, want, tail):
        assert gi == wi == ci and gs == ws
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            np.testing.assert_array_equal(g[k], c[k], err_msg=k)


def test_loader_yields_device_tensors(toy):
    _, tr = toy
    _, tc = both_cfgs(LOADER_OPTS)
    dec = decoder((48, 20))
    host = _loader_batches(tloader.ReIDLoader(tr, tc, num_workers=2,
                                              decode_fn=dec), 0)
    on_cpu = tloader.ReIDLoader(tr, tc, num_workers=2, decode_fn=dec,
                                device='cpu', device_prefetch=2)
    n = 0
    for (i, scale, batch), (hi, hs, h) in zip(on_cpu.iter_epoch(0), host):
        assert (i, scale) == (hi, hs)
        assert all(torch.is_tensor(v) for v in batch.values())
        for k in h:
            np.testing.assert_array_equal(batch[k].numpy(), h[k])
        n += 1
    assert n == len(host) == on_cpu.schedule.ipe


def test_loader_knobs_and_unported_wires(toy):
    _, tr = toy
    _, tc = both_cfgs(LOADER_OPTS + ['DATA_LOADER.NUM_THREADS', '3',
                                     'DATA_LOADER.MINIBATCH_QUEUE_SIZE', '5',
                                     'DATA_LOADER.BLOBS_QUEUE_CAPACITY', '2'])
    t = tloader.ReIDLoader(tr, tc)
    assert (t._num_workers, t._prefetch, t._device_prefetch) == (3, 5, 2)
    # the wires that raised before slice 3b, decided from the metadata
    mixed = [dict(e, height=40) if i % 2 else e for i, e in enumerate(tr)]
    assert tloader.ReIDLoader(mixed, tc)._raw_pad_hw == (48, 20)
    bare = [dict(e, height=None) for e in tr]
    assert not tloader.ReIDLoader(bare, tc)._raw
    assert not tloader.ReIDLoader(tr, tc, raw=False)._raw
    assert t._raw and t._raw_pad_hw is None


def test_loader_worker_failure_and_pk_check(toy):
    _, tr = toy
    _, tc = both_cfgs(LOADER_OPTS)

    def broken(path):
        raise IOError('cannot read ' + path)
    t = tloader.ReIDLoader(tr, tc, num_workers=2, decode_fn=broken)
    with pytest.raises(RuntimeError, match='worker failed'):
        _loader_batches(t, 0)
    with pytest.raises(AssertionError, match='P x K'):
        t._check_pk(np.array([0, 0, 1, 1, 2, 2, 3, 4]))
    t._check_pk(np.array([0, 0, 1, 1, 2, 2, 3, 3]))


def test_decode_image_matches(tmp_path):
    import cv2
    from pps_tpu.data import transforms as jtransforms
    im = decoder((48, 20))('00000003_0001_00000007.jpg')
    path = str(tmp_path / 'im.png')
    assert cv2.imwrite(path, im)
    got = ttransforms.decode_image(path)
    np.testing.assert_array_equal(got, jtransforms.decode_image(path))
    np.testing.assert_array_equal(got, im)
    with pytest.raises(IOError):
        ttransforms.decode_image(str(tmp_path / 'missing.png'))


def test_decode_image_without_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(ImportError, match='decode_fn'):
        ttransforms.decode_image('any.jpg')


def test_transfer_on_cpu():
    t = Transfer('cpu')
    a = np.arange(12, dtype=np.uint8).reshape(3, 4)
    one = t.ready(t.put(a))
    both = t.ready(t.put({'a': a, 'b': a.T}))
    assert torch.equal(one, torch.from_numpy(a))
    assert torch.equal(both['b'], torch.from_numpy(a.T.copy()))
