"""The port's training losses and their hand-written backward passes
against pps_tpu's: ``cross_entropy_with_logits`` (the one-sided 1e4
gradient clip), ``batch_hard`` (gradient to the first argmax / argmin on
ties), the combo-batched distances, and ``softmax_ce_losses``,
``crm_loss`` and ``triplet_losses`` forward and gradient."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pps_tpu.models import losses as jl
from pps_tpu.ops import distance as jd
from pps_tpu.ops.batch_hard import batch_hard as j_batch_hard
from pps_tpu.ops.cross_entropy import cross_entropy_with_logits as j_ce
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.models import losses as tl
from pps_tpu_torch.ops import batch_hard as tbh
from pps_tpu_torch.ops import cross_entropy as tce
from pps_tpu_torch.ops import distance as td

# float32 on both sides; reductions over at most a few hundred terms in
# another order
RTOL, ATOL = 1e-5, 1e-6
J = jnp.asarray  # the JAX package's custom_vjp ops take jax arrays


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


def _grad(fn, *args):
    """(value, grad w.r.t. the first arg) of a scalar torch function."""
    x = torch.tensor(args[0]).requires_grad_(True)
    out = fn(x, *[torch.tensor(a) for a in args[1:]])
    (g,) = torch.autograd.grad(out, [x])
    return out.detach().numpy(), g.numpy()


# ---------------------------------------------------------------------------
# cross entropy on probabilities
# ---------------------------------------------------------------------------


def _ce_inputs():
    rng = np.random.RandomState(0)
    probs = rng.rand(6, 5).astype(np.float32)
    labels = (rng.rand(6, 5) > 0.5).astype(np.float32)
    probs[0, :2] = [0.0, 1.0]          # log clipped at 1e-20 both sides
    labels[0, :2] = [1.0, 0.0]
    probs[1, :2] = [1e-6, 1.0 - 1e-7]  # gradient above the 1e4 clip
    labels[1, :2] = [0.0, 0.0]
    probs[2, 0], labels[2, 0] = 1e-7, 1.0  # large negative: not clipped
    return probs, labels


@pytest.mark.parametrize('dy', [1.0, 0.37, -2.0])
def test_cross_entropy_forward_and_clipped_gradient(dy):
    probs, labels = _ce_inputs()
    want = float(j_ce(J(probs), J(labels)))
    want_g = np.asarray(jax.grad(
        lambda p: dy * j_ce(p, J(labels)))(J(probs)))
    got, got_g = _grad(lambda p, l: dy * tce.cross_entropy_with_logits(p, l),
                       probs, labels)
    assert float(got) == pytest.approx(dy * want, rel=RTOL)
    np.testing.assert_allclose(got_g, want_g, rtol=RTOL, atol=ATOL)
    # the clip is one-sided: the upper bound 1e4 / N only
    n = probs.shape[0]
    assert got_g.max() <= 1e4 / n * (1 + 1e-6)
    if dy > 0:
        assert got_g[1, 1] == pytest.approx(1e4 / n)
        assert got_g[2, 0] < -1e4 / n


def test_cross_entropy_labels_get_no_gradient():
    probs, labels = _ce_inputs()
    lt = torch.tensor(labels).requires_grad_(True)
    out = tce.cross_entropy_with_logits(torch.tensor(probs), lt)
    assert torch.autograd.grad(out, [lt], allow_unused=True)[0] is None


# ---------------------------------------------------------------------------
# batch-hard mining and distances
# ---------------------------------------------------------------------------


def _tied_features(seed=1, n=8, d=6):
    """Rows with duplicates so the hardest positive and negative tie."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    x[5] = x[3]            # a negative of rows 0..1 tied twice
    x[6] = x[2]
    labels = np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32)
    return x, labels


def test_combo_batched_distances_match():
    x = np.random.RandomState(2).randn(3, 7, 5).astype(np.float32)
    want = np.stack([np.asarray(jd.pairwise_sq_dist(xr)) for xr in x])
    got = td.pairwise_sq_dist_batched(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
    xt = torch.tensor(x).requires_grad_(True)
    ct = np.random.RandomState(3).randn(3, 7, 7).astype(np.float32)
    (g,) = torch.autograd.grad(
        (td.pairwise_sq_dist_batched(xt) * torch.tensor(ct)).sum(), [xt])
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(jax.vmap(
        jd.pairwise_sq_dist)(v) * ct))(x))
    np.testing.assert_allclose(g.numpy(), want_g, rtol=RTOL, atol=1e-5)


def test_batch_hard_ties_route_to_first_index():
    x, labels = _tied_features()
    dist = np.sqrt(np.maximum(np.asarray(jd.pairwise_sq_dist(x)), 1e-12))
    # exact ties: equal rows give bit-equal distance columns
    assert dist[0, 3] == dist[0, 5] and dist[7, 2] == dist[7, 6]
    ct_ap = np.random.RandomState(4).randn(8).astype(np.float32)
    ct_an = np.random.RandomState(5).randn(8).astype(np.float32)

    def jax_loss(dm):
        ap, an = j_batch_hard(dm, J(labels))
        return jnp.sum(ap * ct_ap) + jnp.sum(an * ct_an)
    want_ap, want_an = map(np.asarray,
                           jax.jit(j_batch_hard)(J(dist), J(labels)))
    want_g = np.asarray(jax.grad(jax_loss)(J(dist)))

    dt = torch.tensor(dist).requires_grad_(True)
    ap, an = tbh.batch_hard(dt, torch.tensor(labels))
    (g,) = torch.autograd.grad(
        (ap * torch.tensor(ct_ap)).sum() + (an * torch.tensor(ct_an)).sum(),
        [dt])
    np.testing.assert_array_equal(ap.detach().numpy(), want_ap)
    np.testing.assert_array_equal(an.detach().numpy(), want_an)
    np.testing.assert_array_equal(g.numpy(), want_g)
    # per row and side the whole gradient lands on the first of the tied
    # hardest elements
    pos = labels[:, None] == labels[None, :]
    hit = {'ap': np.where(pos, dist, -np.inf), 'an': np.where(pos, np.inf,
                                                               dist)}
    ties = 0
    for a in range(8):
        for side, ext, ct in (('ap', np.max, ct_ap), ('an', np.min, ct_an)):
            cand = np.flatnonzero(hit[side][a] == ext(hit[side][a]))
            ties += len(cand) > 1
            assert g[a, cand[0]] != 0
            assert (g[a, cand[1:]] == 0).all()
    assert ties >= 2


def test_batch_hard_is_batched_over_combos():
    x, labels = _tied_features()
    rng = np.random.RandomState(6)
    stack = np.stack([x, x[::-1].copy(), rng.randn(*x.shape)]).astype(
        np.float32)
    d = np.sqrt(np.maximum(np.stack(
        [np.asarray(jd.pairwise_sq_dist(s)) for s in stack]), 1e-12))
    ap, an = tbh.batch_hard(torch.tensor(d), torch.tensor(labels))
    for r in range(3):
        wap, wan = jax.jit(j_batch_hard)(J(d[r]), J(labels))
        np.testing.assert_array_equal(ap[r].numpy(), np.asarray(wap))
        np.testing.assert_array_equal(an[r].numpy(), np.asarray(wan))


def test_batch_hard_ap_is_relu_at_zero():
    d = -np.ones((4, 4), np.float32)
    ap, _ = tbh.batch_hard(torch.tensor(d), torch.tensor([0, 0, 1, 1]))
    assert (ap.numpy() == 0).all()


# ---------------------------------------------------------------------------
# the model's losses
# ---------------------------------------------------------------------------


def _loss_inputs(b=8, r=7, k=5, d=6, seed=7):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, r, k).astype(np.float32) * 2
    logits[0, 0, 1] = logits[0, 0, 3] = logits[0, 0].max() + 1  # argmax tie
    labels = np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32)[:b]
    # post-ReLU-like and no all-zero row (sqrt of a zero norm has no
    # gradient on either side)
    feats = (np.abs(rng.randn(b, r, d)) + 0.05).astype(np.float32)
    return logits, labels, feats


def test_softmax_ce_losses_forward_and_gradient():
    logits, labels, _ = _loss_inputs()
    ct = np.random.RandomState(8).randn(logits.shape[1]).astype(np.float32)
    jloss, jacc = jl.softmax_ce_losses(logits, labels)
    want_g = np.asarray(jax.grad(lambda z: jnp.sum(
        jl.softmax_ce_losses(z, labels)[0] * ct))(logits))
    lt = torch.tensor(logits).requires_grad_(True)
    loss, acc = tl.softmax_ce_losses(lt, torch.tensor(labels))
    (g,) = torch.autograd.grad((loss * torch.tensor(ct)).sum(), [lt])
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_allclose(g.numpy(), want_g, rtol=RTOL, atol=ATOL)


def test_crm_loss_forward_and_gradient():
    rng = np.random.RandomState(9)
    probs = rng.rand(8, 5).astype(np.float32)
    labels = np.array([0, 1, 2, 3, 4, 0, 1, 2], np.int32)
    oh = np.eye(5, dtype=np.float32)[labels]
    jloss, jacc = jl.crm_loss(J(probs), J(oh), J(labels))
    want_g = np.asarray(jax.grad(
        lambda p: jl.crm_loss(p, J(oh), J(labels))[0])(J(probs)))
    pt = torch.tensor(probs).requires_grad_(True)
    loss, acc = tl.crm_loss(pt, torch.tensor(oh), torch.tensor(labels))
    (g,) = torch.autograd.grad(loss, [pt])
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=RTOL)
    assert float(acc) == float(jacc)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('normalize', [True, False])
def test_triplet_losses_forward_and_gradient(normalize):
    _, labels, feats = _loss_inputs()
    ct = np.random.RandomState(10).randn(3, feats.shape[1]).astype(
        np.float32)

    def jax_loss(f):
        mrc, ap, an = jl.triplet_losses(f, J(labels), normalize=normalize)
        return jnp.sum(mrc * ct[0]) + jnp.sum(ap * ct[1]) + \
            jnp.sum(an * ct[2])
    want = [np.asarray(v) for v in
            jl.triplet_losses(J(feats), J(labels), normalize=normalize)]
    want_g = np.asarray(jax.grad(jax_loss)(J(feats)))
    ft = torch.tensor(feats).requires_grad_(True)
    got = tl.triplet_losses(ft, torch.tensor(labels), normalize=normalize)
    out = sum((v * torch.tensor(c)).sum() for v, c in zip(got, ct))
    (g,) = torch.autograd.grad(out, [ft])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=RTOL,
                                   atol=1e-5)
    # sqrt(max(d2, 1e-12)) has slope ~5e5 near a self-distance, so compare
    # against the gradient's scale
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-4,
                               atol=1e-5 * np.abs(want_g).max())
