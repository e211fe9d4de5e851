"""BN folding in the port against pps_tpu: the folded params are pps_tpu's
bit for bit after the layout transpose (R-50, the FPN2 yaml with its conv
biases, and an AffineChannel body), and the folded body extracts as the
unfolded one and as pps_tpu's folded one."""

import numpy as np
import pytest
import torch

from _torch_port_variants_common import (cut, images, jax_extract, jax_model,
                                         numpy_params, port_extract,
                                         port_model, _two_threads)
from pps_tpu.models.folding import fold_conv_bn as jfold
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.engine.checkpoint import params_from_numpy
from pps_tpu_torch.models.folding import fold_conv_bn as tfold

R50 = 'market1501/pps_crm_triplet_R-50_1x'
FPN2 = 'market1501/pps_crm_triplet_R-50-FPN2_1x'
# folded vs unfolded, both the port's in float32: the BN's affine map
# moved into the conv weights rounds differently, through 53 convs
FOLD_ATOL = 1e-5
# the port's folded extraction vs pps_tpu's on the same folded params:
# float32 conv sums in other orders (measured ~1.2e-7)
PARITY_ATOL = 1e-6
CASES = [(R50, ()), (FPN2, ()), (R50, ('MODEL.USE_BN', 'False'))]
IDS = ['R-50', 'FPN2', 'AffineChannel']


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


@pytest.fixture(scope='module', params=CASES, ids=IDS)
def folded(request):
    yaml, extra = request.param
    jm = jax_model(yaml, cut(extra=extra))
    params, state = numpy_params(jm, seed=11)
    want = {k: np.asarray(v) for k, v in jfold(params, state).items()}
    x = images(2, seed=12)
    want_x = jax_extract(jm, want, state, x)
    tm = port_model(yaml, cut(extra=extra))
    tp, ts = params_from_numpy(tm, params, state)
    got = tfold(tp, ts)
    return {'want': want, 'got': got, 'want_x': want_x,
            'got_x': port_extract(tm, got, ts, x),
            'base_x': port_extract(tm, tp, ts, x),
            'n_fb': sum(k.endswith('_fb') for k in got)}


def test_folded_params_bitwise_pps_tpu(folded):
    want, got = folded['want'], folded['got']
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy()
        if g.ndim == 4:
            g = g.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        np.testing.assert_array_equal(g, w, err_msg=k)
    # every body conv (53) plus, for FPN2, the coarsest conv and a lateral
    assert folded['n_fb'] in (53, 55)


def test_folded_extraction_matches_unfolded(folded):
    np.testing.assert_allclose(folded['got_x'], folded['base_x'], rtol=0,
                               atol=FOLD_ATOL)


def test_folded_extraction_matches_pps_tpu_folded(folded):
    np.testing.assert_allclose(folded['got_x'], folded['want_x'], rtol=0,
                               atol=PARITY_ATOL)


def test_folded_params_survive_on_the_folded_body():
    """The fold leaves the BN params in place (the train path still reads
    them) and adds one float32 bias per folded conv; at the init's BN
    (mean 0, variance 1) the bias is 0 and the weights scale by
    1 / sqrt(1 + eps)."""
    tm = port_model(R50, cut())
    params, state = tm.init(torch.Generator().manual_seed(0))
    f = tfold(params, state)
    assert set(params) < set(f)
    assert f['conv1_fb'].dtype == torch.float32
    assert f['conv1_fb'].shape == (64,)
    assert torch.equal(f['conv1_fb'], torch.zeros(64))
    assert not torch.equal(f['conv1_w'], params['conv1_w'])
