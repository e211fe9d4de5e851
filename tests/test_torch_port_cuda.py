"""Tests of the port that need a CUDA card; each skips without one.

On a GPU host (its environment need not have JAX, which tests/conftest.py
sets up, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

This file imports torch and numpy only.  It holds each kernel against its
plain version and the card's float32 path against the CPU's: extraction,
the exact, streaming and IVF top-k, re-ranking, the train step, and the
int8 body.
"""

import numpy as np
import pytest
import torch

from pps_tpu_torch import config as tcfg
from pps_tpu_torch.engine.serving import QueryEmbedder, RetrievalIndex
from pps_tpu_torch.flagship import flagship_cfg
from pps_tpu_torch.kernels import build
from pps_tpu_torch.kernels import conv2d_int8 as ck
from pps_tpu_torch.kernels import zero_even as ze
from pps_tpu_torch.models.model import build_model
from pps_tpu_torch.evaluation.rerank import re_ranking, rerank_distmat_device
from pps_tpu_torch.ops import ivf
from pps_tpu_torch.ops.topk import flat_topk, quantize_gallery, streaming_topk
from pps_tpu_torch.parallel import eval_step as es

pytestmark = pytest.mark.cuda

_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
         torch.float16: torch.int16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


@pytest.mark.parametrize('dtype', list(_BITS))
def test_zero_even_kernel_equals_plain(cuda, dtype):
    gen = torch.Generator().manual_seed(0)
    for n in (1, 7, 64, 130, 100003):
        x = torch.randn(n, generator=gen).to(dtype)
        x[0] = float('nan')
        if n > 3:
            x[3] = float('nan')
        x = x.to(cuda)
        before = ze.launches
        got = ze.zero_even(x)
        torch.cuda.synchronize()
        assert ze.launches == before + 1
        assert torch.equal(got.view(_BITS[dtype]),
                           ze.zero_even_plain(x).view(_BITS[dtype]))


def test_zero_even_rejects_what_the_kernel_does_not_take(cuda):
    with pytest.raises(TypeError):
        ze.zero_even(torch.zeros(4, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match='contiguous'):
        ze.zero_even(torch.zeros(8, device=cuda)[::2])
    assert ze.zero_even(torch.zeros(0, device=cuda)).shape == (0,)


def test_build_reuses_a_current_library(cuda):
    build.build_all()
    report = build.build_all()
    assert set(report) == set(build.sources())
    assert all(r['seconds'] == 0.0 for r in report.values())
    assert build.library_path('zero_even').exists()


@pytest.fixture
def small_models(cuda):
    cfg = flagship_cfg(scale=(32, 96), num_classes=11, dtype='float32')
    cpu_model = build_model(cfg, device='cpu')
    params, state = cpu_model.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    state = {k: torch.tensor(
        (rng.randn(*v.shape) * 0.1 if k.endswith('_rm')
         else rng.rand(*v.shape) + 0.5).astype(np.float32))
        for k, v in sorted(state.items())}
    card_model = build_model(cfg, device=cuda)
    card = ({k: v.to(cuda) for k, v in params.items()},
            {k: v.to(cuda) for k, v in state.items()})
    return cfg, cpu_model, (params, state), card_model, card


def test_extraction_card_f32_matches_cpu(small_models):
    cfg, cpu_model, (p, s), card_model, (cp, cs) = small_models
    u8 = np.random.RandomState(1).randint(0, 256, (5, 48, 20, 3)).astype(
        np.uint8)
    pre = (cfg.PIXEL_MEANS, (96, 32))
    want = es.extract_features(
        es.make_extract_fn(cpu_model, flip_tta=True, device_preproc=pre,
                           device='cpu'), p, s, u8, batch_size=2)
    got = es.extract_features(
        es.make_extract_fn(card_model, flip_tta=True, device_preproc=pre,
                           device=card_model.device), cp, cs, u8,
        batch_size=2)
    # float32 on both (TF32 off), sums in another order
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('int8', [False, True])
def test_flat_topk_card_matches_cpu(cuda, int8):
    rng = np.random.RandomState(2)
    g = rng.randn(300, 32).astype(np.float32)
    g[100] = g[7]
    g[250] = g[7]  # ties: lowest index first on the card too
    q = rng.randn(5, 32).astype(np.float32)
    q[2] = g[7]
    kw = {}
    gt = torch.tensor(g)
    if int8:
        g8, sc = quantize_gallery(g)
        gt, kw['g_scale'] = torch.tensor(g8), torch.tensor(sc)
    wd, wi = flat_topk(torch.tensor(q), gt, k=12, n_valid=290, **kw)
    kw = {k: v.to(cuda) for k, v in kw.items()}
    gd, gi = flat_topk(torch.tensor(q, device=cuda), gt.to(cuda), k=12,
                       n_valid=290, **kw)
    np.testing.assert_array_equal(gi.cpu().numpy(), wi.numpy())
    assert gi[2, :3].tolist() == [7, 100, 250]
    np.testing.assert_allclose(gd.cpu().numpy() ** 2, wd.numpy() ** 2,
                               atol=1e-4)


def _unit(n, d, seed):
    x = np.random.RandomState(seed).randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _same_topk(got, want, eps=1e-5):
    """Indices equal wherever neighbouring distances differ by more than
    eps (float32 sums in other orders); squared distances within 1e-4."""
    gd, gi = (t.cpu().numpy() for t in got)
    wd, wi = (t.cpu().numpy() for t in want)
    np.testing.assert_allclose(gd ** 2, wd ** 2, rtol=0, atol=1e-4)
    gap = np.diff(wd, axis=1)
    clear = np.ones(wd.shape, bool)
    clear[:, 1:] &= gap > eps
    clear[:, :-1] &= gap > eps
    np.testing.assert_array_equal(gi[clear], wi[clear])


@pytest.mark.parametrize('int8', [False, True])
def test_streaming_matches_flat_on_card(cuda, int8):
    g = _unit(5000, 64, 5)
    g[[300, 4100]] = g[17]          # ties across chunks
    q = _unit(40, 64, 6)
    q[3] = g[17]
    gt, s = torch.tensor(g, device=cuda), None
    if int8:
        gt, s = quantize_gallery(gt)
        g8, s8 = quantize_gallery(g)
        assert np.array_equal(gt.cpu().numpy(), g8)     # the same bytes
        assert np.array_equal(s.cpu().numpy(), s8)
    qt = torch.tensor(q, device=cuda)
    st = streaming_topk(qt, gt, k=100, chunk=1024, g_scale=s)
    fl = flat_topk(qt, gt, k=100, g_scale=s)
    _same_topk(st, fl)
    assert st[1][3, :3].tolist() == [17, 300, 4100]
    cpu = streaming_topk(qt.cpu(), gt.cpu(), k=100, chunk=1024,
                         g_scale=None if s is None else s.cpu())
    _same_topk(st, cpu)


def test_ivf_full_probe_equals_exact_on_card(cuda):
    g = _unit(6000, 48, 7)
    q = _unit(30, 48, 8)
    cent = ivf.kmeans(g, 32, iters=4, device=cuda)
    assign = ivf.assign_clusters(g, cent)
    perm, starts = ivf.build_ivf(assign, cent.shape[0])
    gs = torch.tensor(g[perm], device=cuda)
    qt = torch.tensor(q, device=cuda)
    got = ivf.ivf_topk(qt, gs, cent, torch.tensor(starts, device=cuda),
                       k=50, nprobe=cent.shape[0], budget=len(g),
                       chunk=2048)
    _same_topk(got, streaming_topk(qt, gs, k=50, chunk=2048))
    # the card's k-means from the same rows as the CPU's
    np.testing.assert_allclose(
        cent.cpu().numpy(), ivf.kmeans(g, 32, iters=4, device='cpu').numpy(),
        rtol=0, atol=1e-4)


def test_rerank_device_on_card_matches_cpu_numpy(cuda):
    rng = np.random.RandomState(9)
    centers = rng.randn(20, 32)
    f = centers[rng.randint(0, 20, 400)] + 0.7 * rng.randn(400, 32)
    f = (f / np.linalg.norm(f, axis=1, keepdims=True)).astype(np.float32)
    q, g = f[:80], f[80:]

    def dist(a, b):
        return np.sqrt(np.maximum(
            (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
            - 2 * a @ b.T, 0)).astype(np.float32)
    qg, qq, gg = dist(q, g), dist(q, q), dist(g, g)
    want = re_ranking(qg, qq, gg)
    got = rerank_distmat_device(qg, qq, gg, device=cuda)
    assert got.device.type == 'cuda'
    far = np.abs(got.cpu().numpy() - want) > 1e-5
    assert far.mean() <= 0.005, far.mean()   # near-tie membership flips


def test_serving_on_card_matches_cpu(small_models):
    cfg, cpu_model, (p, s), card_model, (cp, cs) = small_models
    decodes = np.random.RandomState(3).randint(
        0, 256, (6, 48, 20, 3)).astype(np.uint8)
    on_cpu = QueryEmbedder(cfg, cpu_model, p, s, max_batch=4, device='cpu')
    on_card = QueryEmbedder(cfg, card_model, cp, cs, max_batch=4,
                            device=card_model.device)
    on_card.warmup(raw_hw=(48, 20))
    want = on_cpu.embed([0, 1, 2, 3, 4], lambda i: decodes[i])
    got = on_card.embed([0, 1, 2, 3, 4], lambda i: decodes[i])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    for int8 in (False, True):
        a = RetrievalIndex(want, list('abcde'), int8=int8, device='cpu')
        b = RetrievalIndex(want, list('abcde'), int8=int8,
                           device=card_model.device)
        b.add(want[:1], ['f'])
        a.add(want[:1], ['f'])
        da, ia, pa = a.search(got, 3, return_paths=True)
        db, ib, pb = b.search(got, 3, return_paths=True)
        np.testing.assert_array_equal(ib, ia)
        assert pb == pa
        np.testing.assert_allclose(db ** 2, da ** 2, atol=1e-4)


def _rms(t):
    return float(torch.sqrt(torch.mean(t.double().cpu() ** 2)))


def test_cross_entropy_and_batch_hard_backward_card_matches_cpu(cuda):
    from pps_tpu_torch.ops.batch_hard import batch_hard
    from pps_tpu_torch.ops.cross_entropy import cross_entropy_with_logits
    rng = np.random.RandomState(4)
    probs = rng.rand(16, 9).astype(np.float32)
    probs[0, :3] = [0.0, 1.0, 1e-7]          # clipped log, clipped grad
    labels = (rng.rand(16, 9) > 0.5).astype(np.float32)
    x = rng.randn(31, 8, 16).astype(np.float32)
    x[:, 5] = x[:, 3]                        # exact ties in every combo
    lab = torch.tensor([0, 0, 1, 1, 2, 2, 3, 3])
    dist = torch.cdist(torch.tensor(x), torch.tensor(x))
    out = {}
    for dev in ('cpu', cuda):
        p = torch.tensor(probs, device=dev).requires_grad_(True)
        ce = cross_entropy_with_logits(p, torch.tensor(labels, device=dev))
        d = dist.to(dev).requires_grad_(True)
        ap, an = batch_hard(d, lab.to(dev))
        loss = ce + (ap * 0.3).sum() - an.sum()
        gp, gd = torch.autograd.grad(loss, [p, d])
        out[str(dev)] = (ce.detach().cpu(), gp.cpu(), gd.cpu(),
                         ap.detach().cpu(), an.detach().cpu())
    cpu, card = out['cpu'], out[str(cuda)]
    torch.testing.assert_close(card[0], cpu[0], rtol=1e-6, atol=0)
    torch.testing.assert_close(card[1], cpu[1], rtol=1e-6, atol=1e-7)
    # the distances are the same input on both sides, so the mining, its
    # first-index tie rule and the routed gradient are exact
    for a, b in zip(card[2:], cpu[2:]):
        assert torch.equal(a, b)


def test_train_step_card_f32_matches_cpu(cuda):
    """One train step on the uint8 wire at the small size, the same draws
    on both sides; each residual branch's last BN scale at 0.01 keeps the
    gradient well conditioned (see tests/test_torch_port_train_step.py)."""
    from pps_tpu_torch.data import device_augment as aug
    from pps_tpu_torch.parallel.train_step import make_train_step
    from pps_tpu_torch.solver import optimizer as opt
    cfg = flagship_cfg(scale=(32, 96), num_classes=11, ims_per_batch=8, p=4,
                       k=2, dtype='float32')
    cpu_model = build_model(cfg, device='cpu')
    params, state = cpu_model.init(torch.Generator().manual_seed(0))
    params = {k: v * 0.01 if k.endswith('_branch2c_bn_s') else v
              for k, v in params.items()}
    rng = np.random.RandomState(5)
    labels = torch.tensor(np.repeat(np.arange(4), 2) * 2 + 1)
    batch = {'data_u8': torch.tensor(rng.randint(0, 256, (8, 48, 20, 3))
                                     .astype(np.uint8)),
             'flipped': torch.tensor(np.arange(8) % 2 == 0),
             'labels_int32': labels.int(),
             'labels_oh': torch.nn.functional.one_hot(labels, 10).float()}
    gen = torch.Generator().manual_seed(6)
    draws = {'augment': aug.sample_params(gen, aug.augment_spec(cfg), 8,
                                          (48, 20), torch.device('cpu')),
             'dropout_mask': torch.rand(8, 31, 128, generator=gen) < 0.8}
    card_model = build_model(cfg, device=cuda)
    meta = opt.make_param_meta(params, cfg)
    out = []
    for model in (cpu_model, card_model):
        dev = model.device

        def put(tree):
            return {k: v.to(dev) for k, v in tree.items()}
        step = make_train_step(model, cfg, meta, device=dev)
        ts = {'params': put(params), 'state': put(state),
              'opt': opt.init_opt_state(put(params))}
        new, logs = step(ts, put(batch), 0.01, 1.0, None,
                         draws={'augment': put(draws['augment']),
                                'dropout_mask': draws['dropout_mask'].to(
                                    dev)})
        out.append((new, float(logs['loss'])))
    (cn, closs), (gn, gloss) = out
    assert gloss == pytest.approx(closs, rel=1e-4)
    # float32 on both sides (TF32 off), other kernels' sum orders: the step
    # agrees as the port's does with the JAX package's on the CPU (5% RMS,
    # plus 2% of the RMS over all params for the updates that are zero by
    # a BN invariance; tests/test_torch_port_train_step.py)
    disp = {k: cn['params'][k] - params[k] for k in params}
    floor = 0.02 * _rms(torch.cat([d.flatten() for d in disp.values()]))
    for k in params:
        d_g = gn['params'][k].cpu() - params[k]
        assert _rms(d_g - disp[k]) <= 0.05 * _rms(disp[k]) + floor, k
        m_c, m_g = cn['opt']['momentum'][k], gn['opt']['momentum'][k].cpu()
        assert _rms(m_g - m_c) <= 0.05 * _rms(m_c) + floor, k
    for k in state:
        assert _rms(gn['state'][k].cpu() - cn['state'][k]) <= \
            1e-3 * _rms(cn['state'][k]), k


def _tiny_roidb(n_ids=4, per_id=4, hw=(48, 20)):
    """A roidb and a decode_fn for it, without files or JAX."""
    roidb = []
    for pid in range(1, n_ids + 1):
        for j in range(per_id):
            iid = len(roidb) + 1
            roidb.append({'im_name': '{:08d}_{:04d}_{:08d}.jpg'.format(
                pid, j % 2 + 1, iid), 'image': str(iid), 'gt_class': pid,
                'height': hw[0], 'width': hw[1], 'flipped': j % 2 == 1,
                'mark': 0 if j == 0 else 1})

    def decode(path):
        return np.random.RandomState(int(path)).randint(
            0, 256, hw + (3,)).astype(np.uint8)
    return roidb, decode


def test_loader_batches_on_card_equal_host(cuda):
    from pps_tpu_torch.data.loader import ReIDLoader
    roidb, decode = _tiny_roidb()
    cfg = flagship_cfg(scale=(32, 96), num_classes=5, ims_per_batch=8, p=4,
                       k=2, dtype='float32')
    host = [b for _, _, b in ReIDLoader(roidb, cfg, num_workers=2,
                                        decode_fn=decode).iter_epoch(1)]
    card = [b for _, _, b in ReIDLoader(roidb, cfg, num_workers=2,
                                        decode_fn=decode, device=cuda,
                                        device_prefetch=3).iter_epoch(1)]
    assert len(card) == len(host) > 0
    for c, h in zip(card, host):
        for k in h:
            assert c[k].device.type == 'cuda'
            np.testing.assert_array_equal(c[k].cpu().numpy(), h[k])


def test_cmc_map_device_card_matches_cpu(cuda):
    from pps_tpu_torch.evaluation.device_eval import cmc_map_device
    rng = np.random.RandomState(7)
    dist = np.round(rng.rand(50, 300), 2).astype(np.float32)  # many ties
    dist[3, :40] = np.inf
    dist[4, 10:20] = np.nan
    q_ids, g_ids = rng.randint(0, 12, 50), rng.randint(0, 12, 300)
    q_cams, g_cams = rng.randint(0, 4, 50), rng.randint(0, 4, 300)
    m_c, c_c = cmc_map_device(dist, q_ids, g_ids, q_cams, g_cams,
                              device='cpu')
    m_g, c_g = cmc_map_device(torch.tensor(dist, device=cuda), q_ids, g_ids,
                              q_cams, g_cams)
    assert c_g.device.type == 'cuda'
    np.testing.assert_array_equal(c_g.cpu().numpy(), c_c.numpy())
    assert float(m_g) == pytest.approx(float(m_c), rel=0, abs=1e-12)


def test_train_model_on_card_snapshot_equals_final(cuda, tmp_path):
    """Two epochs on the card: epoch 0's snapshot (copied on a side
    stream, written by the background writer) and model_final.pkl hold
    what the run held at those points; the final one loads back."""
    import shutil
    from pps_tpu_torch.config import merge_cfg_from_list
    from pps_tpu_torch.engine.train import train_model
    from pps_tpu_torch.utils.io import load_object
    roidb, decode = _tiny_roidb()
    cfg = flagship_cfg(scale=(32, 96), num_classes=5, ims_per_batch=8, p=4,
                       k=2, dtype='float32')
    cfg.immutable(False)
    merge_cfg_from_list(['SOLVER.MAX_ITER', '1', 'TRAIN.SNAPSHOT_ITERS', '1',
                         'SOLVER.WARM_UP_ITERS', '0'])
    try:
        ck = train_model(cfg, output_dir=str(tmp_path), roidb=roidb,
                         decode_fn=decode, num_workers=2, device=cuda)
        snap = load_object(ck[0])['blobs']
        final = load_object(ck['final'])['blobs']
        assert sorted(snap) == sorted(final)
        for k in final:
            np.testing.assert_array_equal(snap[k], final[k], err_msg=k)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


def test_padded_augment_card_matches_cpu(cuda):
    """The padded wire with every op on (crops, HSV, blur, erasing) and
    flips, the same draws on both sides: the uint8 stage bitwise, the
    float32 output within 1e-4 (the resize products sum in another order;
    see tests/test_torch_port_augment.py)."""
    from pps_tpu_torch.data import device_augment as aug
    sizes = [(48, 20), (47, 19), (46, 18), (40, 16), (48, 17), (44, 20),
             (36, 14), (47, 20)]
    rng = np.random.RandomState(3)
    padded = np.stack([np.pad(rng.randint(0, 256, s + (3,)).astype(np.uint8),
                              ((0, 48 - s[0]), (0, 20 - s[1]), (0, 0)),
                              mode='reflect') for s in sizes])
    valid = torch.tensor(sizes, dtype=torch.int32)
    flipped = torch.tensor(np.arange(8) % 2 == 1)
    spec = dict(crop_prob=0.7, crop_ratio=0.7, hcrop_prob=0.5,
                hcrop_ratio=0.8, hsv_prob=1.0, sat_range=30, hue_range=20,
                val_range=30, blur_prob=1.0, blur_kernel=7, erase_prob=0.8,
                sl=0.02, sh=0.4, r1=0.3, out_hw=(96, 32))
    means = np.array([[[102.9801, 115.9465, 122.7717]]])
    params = aug.sample_params(torch.Generator().manual_seed(1), spec, 8,
                               (valid[:, 0], valid[:, 1]),
                               torch.device('cpu'))
    out, stages = [], []
    real = aug.crop_resize_batch

    def record(xf, *a):
        stages.append(xf.cpu())
        return real(xf, *a)
    aug.crop_resize_batch = record
    try:
        for dev in ('cpu', cuda):
            out.append(aug.apply_augment(
                torch.tensor(padded).to(dev), flipped.to(dev),
                {k: v.to(dev) for k, v in params.items()}, spec, means,
                valid_hw=valid.to(dev)).cpu())
    finally:
        aug.crop_resize_batch = real
    assert torch.equal(stages[0], stages[1])
    assert float((out[0] - out[1]).abs().max()) <= 1e-4


def test_remat_train_forward_card(cuda):
    """TPU.REMAT on the card: the loss and the BN updates equal those
    without it, and the gradients agree to float32 rounding (the
    recomputed convolutions may pick other cuDNN algorithms)."""
    cfg = flagship_cfg(scale=(32, 96), num_classes=11, ims_per_batch=8, p=4,
                       k=2, dtype='float32')
    model = build_model(cfg, device=cuda)
    params, state = model.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(2)
    labels = torch.tensor(np.repeat(np.arange(4), 2) * 2 + 1, device=cuda)
    batch = {'data': torch.tensor(rng.randn(8, 96, 32, 3).astype(np.float32)
                                  * 50, device=cuda),
             'labels_int32': labels.int(),
             'labels_oh': torch.nn.functional.one_hot(labels, 10).float()}
    mask = torch.rand(8, 31, 128, generator=torch.Generator().manual_seed(3)
                      ) < 0.8
    out = {}
    for remat in (False, True):
        cfg.immutable(False)
        cfg.TPU.REMAT = remat
        cfg.immutable(True)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            total, (updates, _) = model.train_forward(
                leaves, state, batch, None, 1.0, dropout_mask=mask.to(cuda))
            grads = torch.autograd.grad(total, list(leaves.values()))
        out[remat] = (total.detach(), updates, grads)
    (t0, u0, g0), (t1, u1, g1) = out[False], out[True]
    assert torch.equal(t0, t1)
    for k in u0:
        assert torch.equal(u0[k], u1[k]), k
    for a, b in zip(g0, g1):
        assert _rms(a - b) <= 1e-4 * _rms(a) + 1e-12


INT8_CONVS = [  # (n, c_in, h, w, c_out, k, stride, dilation, groups, per_ch)
    (2, 3, 96, 32, 64, 7, 2, 1, 1, False),     # the stem, K = 147
    (2, 64, 24, 8, 64, 3, 1, 1, 1, False),
    (2, 256, 24, 8, 128, 1, 2, 1, 1, False),   # a strided branch1
    (3, 64, 13, 7, 70, 3, 1, 1, 1, False),     # ragged M and N tiles
    (2, 64, 12, 10, 96, 3, 1, 2, 1, False),    # dilated
    (2, 64, 12, 10, 64, 3, 1, 1, 2, True),     # grouped, per-channel
    (2, 8, 12, 10, 16, 3, 1, 1, 4, True),      # cg 2: the element path
    (2, 512, 24, 8, 512, 3, 1, 1, 1, False),   # K 4,608, N 512 (res5 3x3)
    (1, 512, 24, 8, 2048, 1, 1, 1, 1, False),  # N 2,048 (res5 branch2c)
    (2, 256, 96, 32, 512, 1, 2, 1, 1, False),  # res3's strided 1x1
    (60, 256, 24, 8, 256, 3, 1, 1, 1, False),  # M of the tail's 60 images
]


@pytest.mark.parametrize('case', INT8_CONVS)
def test_conv2d_int8_kernel_equals_plain(cuda, case):
    """The int8 kernel against its plain version on the card: the int32
    accumulators and the bf16 / float32 outputs bit for bit."""
    n, cin, h, w, cout, k, s, d, g, per_ch = case
    gen = torch.Generator().manual_seed(sum(case[:8]))
    x_dtype = torch.float32 if cin == 3 else torch.bfloat16
    x = (torch.randn(n, cin, h, w, generator=gen) * 3).to(x_dtype).to(
        cuda).contiguous(memory_format=torch.channels_last)
    wq = torch.randint(-127, 128, (cout, k, k, cin // g), generator=gen,
                       dtype=torch.int8).to(cuda)
    xinv = (torch.rand(cin, generator=gen) * 20 + 1) if per_ch \
        else torch.tensor(17.3)
    osc = torch.rand(cout, generator=gen) * 1e-4
    fb = torch.randn(cout, generator=gen)
    args = (x, wq) + tuple(t.to(cuda) for t in (xinv, osc, fb))
    for out_dtype in (torch.int32, torch.bfloat16, torch.float32):
        kw = dict(stride=s, dilation=d, groups=g,
                  accumulators=out_dtype == torch.int32)
        if out_dtype != torch.int32:
            kw['out_dtype'] = out_dtype
        before = ck.launches
        got = ck.conv2d_int8(*args, **kw)
        want = ck.conv2d_int8_plain(*args, **kw)
        torch.cuda.synchronize()
        assert ck.launches == before + 1
        assert got.dtype == want.dtype == out_dtype
        assert got.is_contiguous(memory_format=torch.channels_last)
        bits = {torch.int32: torch.int32, torch.float32: torch.int32,
                torch.bfloat16: torch.int16}[out_dtype]
        assert torch.equal(got.view(bits), want.view(bits)), out_dtype


def test_conv2d_int8_route_is_the_c_entrys(cuda):
    """The C entry picks the route kernels/conv2d_int8.py:route says, on
    the R-50 body's convs and every case above."""
    cfg = flagship_cfg()
    w_in, h_in = cfg.REID.SCALE
    from pps_tpu_torch.models import resnet as resnet_lib
    shapes = [(64,) + c[1:] for c in ck.resnet_body_convs(
        resnet_lib.resnet_spec(cfg, 50), h_in, w_in)]
    shapes += [c[:9] for c in INT8_CONVS]
    for n, cin, h, w, cout, k, s, d, g in shapes:
        dt = torch.float32 if cin == 3 else torch.bfloat16
        assert ck.native_route(dt, n, cin, h, w, cout, k, k, s, d, g) == \
            ck.route(dt, n, cin, h, w, cout, k, k, s, d, g)


def test_conv2d_int8_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(1, 8, 4, 4, device=cuda)  # NCHW memory, not NHWC
    wq = torch.zeros(4, 3, 3, 8, dtype=torch.int8, device=cuda)
    one, osc, fb = (torch.tensor(1.0, device=cuda),
                    torch.ones(4, device=cuda), torch.zeros(4, device=cuda))
    with pytest.raises(ValueError, match='channels_last'):
        ck.conv2d_int8(x, wq, one, osc, fb)
    with pytest.raises(ValueError, match='is on'):
        ck.conv2d_int8(x.contiguous(memory_format=torch.channels_last), wq,
                       one.cpu(), osc, fb)


def test_int8_extraction_card_matches_cpu(small_models):
    """The int8 body quantized on the CPU, run on the card through the
    kernel (53 launches a batch) and on the CPU through its plain version:
    the int8 body is exact integer arithmetic with the same float32
    epilogue, so only the head's float32 sums differ."""
    from pps_tpu_torch.models.quantize import quantize_for_eval
    cfg, cpu_model, (p, s), card_model, (cp, cs) = small_models
    calib = np.random.RandomState(4).randn(4, 96, 32, 3).astype(
        np.float32) * 50
    qp = quantize_for_eval(cpu_model, p, s, calib)
    x = torch.tensor(np.random.RandomState(5).randn(3, 96, 32, 3).astype(
        np.float32) * 50)
    want = cpu_model.extract_features(qp, s, x)
    before = ck.launches
    dev = card_model.device
    got = card_model.extract_features({k: v.to(dev) for k, v in qp.items()},
                                      cs, x.to(dev))
    torch.cuda.synchronize()
    assert ck.launches - before == 53
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the data mesh on the card: two ranks share it over gloo; NCCL refuses
# ---------------------------------------------------------------------------


def test_collectives_on_two_ranks_sharing_the_card(cuda, tmp_path):
    """The collectives and the global BN statistics on CUDA tensors, two
    ranks on cuda:0 over gloo, against one process on the CPU."""
    from _torch_port_dist import (check_collectives, collectives_payload,
                                  run_ranks)
    payload = collectives_payload(2, device='cuda:0')
    check_collectives(run_ranks('collectives', 2, str(tmp_path), payload,
                                timeout=180), payload)


def test_nccl_with_two_ranks_on_one_card_raises(cuda, tmp_path):
    """NCCL asked for with two ranks on cuda:0 raises on both (before any
    collective, so nothing hangs)."""
    from _torch_port_dist import collectives_payload, run_ranks
    payload = dict(collectives_payload(2, device='cuda:0'), backend='nccl')
    with pytest.raises(RuntimeError, match='NCCL needs one CUDA device'):
        run_ranks('collectives', 2, str(tmp_path), payload, timeout=120)


def test_sharded_topk_on_the_card_equals_the_flat_route(cuda):
    """Four shards on cuda:0 (each its own tensor) against the unsharded
    flat route on the card, int8 and float32; IVF with every cell probed
    against the exact scan."""
    from pps_tpu_torch.parallel import mesh as mesh_lib
    from pps_tpu_torch.parallel import retrieval as ret
    gen = torch.Generator().manual_seed(3)
    g = torch.randn(10007, 256, generator=gen)
    g = g / torch.linalg.norm(g, dim=1, keepdim=True)
    q = g[:33] + 0.05 * torch.randn(33, 256, generator=gen)
    mesh = mesh_lib.build_mesh(devices=['cuda:0'] * 4)
    for int8 in (False, True):
        shards, scales, n = ret.shard_gallery(g.to(cuda), mesh, int8=int8)
        assert len(shards) == 4 and n == len(g)
        d, i = ret.sharded_topk(q, shards, ng_total=n, k=50, chunk=1024,
                                g_scale=scales)
        g_in, s_in = quantize_gallery(g.to(cuda)) if int8 else (g.to(cuda),
                                                                 None)
        wd, wi = flat_topk(q.to(cuda), g_in, k=50, g_scale=s_in)
        np.testing.assert_array_equal(i.cpu().numpy(), wi.cpu().numpy())
        np.testing.assert_allclose(d.cpu().numpy(), wd.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    cent = ivf.kmeans(g.numpy(), 64, iters=4, seed=0, device=cuda)
    assign = ivf.assign_clusters(g.to(cuda), cent)
    placed = ret.shard_ivf_gallery(g.numpy(), assign, 64, mesh)
    d, i = ret.sharded_ivf_topk(q, cent, placed, k=20, nprobe=64,
                                budget=len(g))
    wd, wi = flat_topk(q.to(cuda), g.to(cuda), k=20)
    np.testing.assert_array_equal(np.sort(i.cpu().numpy(), 1),
                                  np.sort(wi.cpu().numpy(), 1))


def test_iter_flavor_card_equals_cpu_bitwise(cuda):
    """The 'iter' SGD flavor (ITER_SIZE 3, one device) for 6 steps from the
    same params and gradients: every param, momentum and accumulator on the
    card bitwise equal to the CPU's.  The accumulated gradient is divided
    by a tensor on its device; a Python float divisor becomes a product
    with its float32 reciprocal on the card, an ulp off the quotient."""
    from pps_tpu_torch.solver import optimizer as opt
    cfg = flagship_cfg(scale=(32, 96), num_classes=11)
    rng = np.random.RandomState(0)
    shapes = {'conv1_w': (64, 3, 7, 7), 'res_conv1_bn_s': (64,),
              'pps0_fc_w': (128, 10), 'pps0_fc_b': (10,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    meta = opt.make_param_meta(params, cfg)
    out = []
    for dev in ('cpu', cuda):
        p = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
        st = opt.init_opt_state(p, 'iter', 3)
        for step in range(6):
            g_rng = np.random.RandomState(10 + step)
            grads = {k: torch.from_numpy(
                g_rng.randn(*s).astype(np.float32)).to(dev)
                for k, s in shapes.items()}
            p, st = opt.sgd_update(p, grads, st, 0.01 * (step + 1), meta,
                                   flavor='iter', iter_size=3, num_devices=1)
        out.append((p, st))
    (cp, cs), (gp, gs) = out
    assert int(gs['count']) == int(cs['count']) == 6
    for k in shapes:
        assert torch.equal(gp[k].cpu(), cp[k]), k
        assert torch.equal(gs['momentum'][k].cpu(), cs['momentum'][k]), k
        assert torch.equal(gs['acmgrad'][k].cpu(), cs['acmgrad'][k]), k
