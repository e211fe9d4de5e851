"""zero_even: the plain version equals the TPU kernel (interpret mode) bit
for bit; the wrapper takes the plain version only for CPU tensors; the
CUDA kernel equals the plain version on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pps_tpu.ops.pallas.zero_even import zero_even as jax_zero_even
from pps_tpu_torch.kernels import build
from pps_tpu_torch.kernels import zero_even as ze

_BITS = {torch.float32: (torch.int32, np.int32, jnp.float32),
         torch.bfloat16: (torch.int16, np.int16, jnp.bfloat16)}


def _input(n):
    x = np.random.RandomState(0).randn(n).astype(np.float32)
    x[0] = np.nan                # NaN at an even index becomes 0
    if n > 3:
        x[3] = np.nan            # NaN at an odd index is copied
    return x


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n', [1, 7, 64, 130])
def test_plain_equals_tpu_kernel_bitwise(n, dtype):
    tbits, nbits, jdt = _BITS[dtype]
    xj = jnp.asarray(_input(n), jdt)
    # both sides get the same input bits (the frameworks round a float32
    # NaN to different bf16 NaN patterns)
    xt = torch.from_numpy(np.asarray(xj).view(nbits).copy()).view(dtype)
    want = np.asarray(jax_zero_even(xj, interpret=True))
    got = ze.zero_even_plain(xt)
    assert got.dtype == dtype and got.shape == (n,)
    np.testing.assert_array_equal(got.view(tbits).numpy(),
                                  want.view(nbits))


def test_rejects_2d():
    x = torch.zeros(2, 4)
    with pytest.raises(AssertionError):
        ze.zero_even(x)
    with pytest.raises(AssertionError):
        ze.zero_even_plain(x)


def test_cpu_tensor_takes_plain_version(monkeypatch):
    def no_build(name):
        raise AssertionError('a CPU tensor must not build the kernel')
    monkeypatch.setattr(build, 'load', no_build)
    before = ze.launches
    x = torch.tensor(_input(9))
    got = ze.zero_even(x)
    assert torch.equal(got.view(torch.int32),
                       ze.zero_even_plain(x).view(torch.int32))
    assert ze.launches == before


def test_other_devices_raise():
    with pytest.raises(ValueError, match='unsupported device'):
        ze.zero_even(torch.empty(4, device='meta'))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc -> a clear error, never a quiet fallback."""
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path)
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        build.build_all(['zero_even'])


def test_library_path_tracks_source(monkeypatch, tmp_path):
    assert 'zero_even' in build.sources()
    first = build.library_path('zero_even')
    assert first.parent == build.BUILD_DIR
    (tmp_path / 'zero_even.cu').write_text('// edited\n')
    monkeypatch.setattr(build, 'CSRC', tmp_path)
    assert build.library_path('zero_even') != first
    assert build.sources() == ['zero_even']
