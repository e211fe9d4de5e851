"""The shipped yamls in the port: every one builds and extracts on the
CPU, and the variants that ran before the FPN / int8 / GN slice (the bpm
and youtu heads, PPS without CRM, R-101 and R-152, the Duke and CUHK03
yamls) equal pps_tpu's extraction on the same weights, in float32 at
96x32."""

import glob
import os

import numpy as np
import pytest
import torch

from _torch_port_variants_common import (cut, images, jax_extract, jax_model,
                                         numpy_params, port_extract,
                                         port_model, ROOT, _two_threads)
from pps_tpu_torch import config as tcfg
from pps_tpu_torch.models.quantize import quantize_for_eval

# float32 on both sides through the body and the head, conv sums in other
# orders: unit-norm embeddings agree to ~2e-7 (measured)
EXTRACT_ATOL = 1e-6

VARIANTS = ['market1501/bpm_R-50_1x', 'market1501/youtu_R-50_1x',
            'market1501/pps_R-50_1x', 'market1501/pps_crm_triplet_R-101_1x',
            'market1501/pps_crm_triplet_R-152_1x', 'duke/pps_R-50_1x',
            'cuhk03/pps_crm_R-50_1x']
CONFIGS = os.path.join(ROOT, 'configs')
YAMLS = sorted(os.path.relpath(p, CONFIGS)[:-5]
               for p in glob.glob(os.path.join(CONFIGS, '*', '*.yaml')))


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


@pytest.mark.parametrize('yaml', VARIANTS)
def test_variant_extraction_matches_pps_tpu(yaml):
    jm = jax_model(yaml, cut())
    params, state = numpy_params(jm, seed=3)
    x = images(2, seed=4)
    want = jax_extract(jm, params, state, x, op_by_op=True)
    tm = port_model(yaml, cut())
    got = port_extract(tm, params, state, x)
    assert got.shape == want.shape == (2, tm.embedding_dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=EXTRACT_ATOL)


def test_every_shipped_yaml_is_listed():
    assert len(YAMLS) == 18
    assert set(VARIANTS) < set(YAMLS)


@pytest.mark.parametrize('yaml', YAMLS)
def test_every_shipped_yaml_builds_and_extracts_in_the_port(yaml):
    """The port's own init at 96x32; an INT8_EVAL yaml extracts through
    its quantized body, calibrated on the same two images."""
    tm = port_model(yaml, cut())
    params, state = tm.init(torch.Generator().manual_seed(0))
    x = torch.tensor(images(2, seed=5))
    if tcfg.cfg.TPU.INT8_EVAL:
        params = quantize_for_eval(tm, params, state, x.numpy())
        assert sum(k.endswith('_wq') for k in params) == 53
    out = tm.extract_features(params, state, x)
    assert out.shape == (2, tm.embedding_dim)
    assert torch.isfinite(out).all()
    if tcfg.cfg.REID.NORMALIZE_FEATURE:
        np.testing.assert_allclose(out.norm(dim=1).numpy(), 1.0, atol=1e-5)
