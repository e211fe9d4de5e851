"""Tests of the port that need a CUDA card; each skips without one.

On a GPU host (its environment need not have JAX, which tests/conftest.py
sets up, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

This file imports torch and numpy only.  It holds each kernel against its
plain version and the card's float32 path against the CPU's.
"""

import numpy as np
import pytest
import torch

from pps_tpu_torch import config as tcfg
from pps_tpu_torch.engine.serving import QueryEmbedder, RetrievalIndex
from pps_tpu_torch.flagship import flagship_cfg
from pps_tpu_torch.kernels import build
from pps_tpu_torch.kernels import zero_even as ze
from pps_tpu_torch.models.model import build_model
from pps_tpu_torch.ops.topk import flat_topk, quantize_gallery
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
