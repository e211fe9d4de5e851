"""On-device image preprocessing: cv2-exact bicubic resize as two matmuls.

Counterpart of ``pps_tpu/data/device_preprocess.py``.  Bicubic resize is
a linear map, so for a fixed (in_size, out_size) it is two small products

    out[H', W'] = R_h [H', H] @ im [H, W] @ R_w[W', W]^T

with R built from cv2's INTER_CUBIC semantics: src = (dst + 0.5) * in/out
- 0.5, the 4-tap Keys kernel with a = -0.75, taps clamped at the borders
(BORDER_REPLICATE).  Decode stays on the host (uint8); cast, mean
subtraction and resize run on the device.  Nothing here needs cv2.

``preprocess_on_device_padded`` is the mixed-size form: decodes padded to
one dataset-global bucket, with per-sample resize matrices that cover each
sample's valid window.
"""

import functools

import numpy as np
import torch

_CV2_A = -0.75  # cv2's bicubic coefficient (interpolation.cpp)


def _keys(d, a=_CV2_A):
    d = abs(float(d))
    if d <= 1.0:
        return (a + 2.0) * d ** 3 - (a + 3.0) * d ** 2 + 1.0
    if d < 2.0:
        return a * (d ** 3 - 5.0 * d ** 2 + 8.0 * d - 4.0)
    return 0.0


def cv2_bicubic_matrix(in_size, out_size):
    """[out_size, in_size] float32 numpy resize matrix matching cv2
    INTER_CUBIC (including replicated borders)."""
    m = np.zeros((out_size, in_size), np.float64)
    scale = in_size / out_size
    for o in range(out_size):
        src = (o + 0.5) * scale - 0.5
        ix = int(np.floor(src))
        t = src - ix
        for tap in range(-1, 3):
            w = _keys(tap - t)
            j = min(max(ix + tap, 0), in_size - 1)  # BORDER_REPLICATE clamp
            m[o, j] += w
    return m.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _matrices(in_hw, out_hw, device):
    """(R_h, R_w) float32 tensors on ``device``, built once per shape."""
    rh = cv2_bicubic_matrix(in_hw[0], out_hw[0])
    rw = cv2_bicubic_matrix(in_hw[1], out_hw[1])
    return (torch.as_tensor(rh, device=device),
            torch.as_tensor(rw, device=device))


def resize_bicubic(x, out_hw):
    """[B, H, W, C] float32 -> [B, H', W', C], cv2-INTER_CUBIC-exact."""
    rh, rw = _matrices((x.shape[1], x.shape[2]), tuple(out_hw), x.device)
    y = torch.einsum('Oh,bhwc->bOwc', rh, x)
    return torch.einsum('Ow,bHwc->bHOc', rw, y)


def preprocess_on_device(images_u8, pixel_means, out_hw):
    """uint8 [B, H, W, 3] BGR tensor -> float32 [B, H', W', 3],
    mean-subtracted then resized (the reference's order)."""
    means = torch.as_tensor(np.asarray(pixel_means, np.float32).reshape(-1),
                            device=images_u8.device)
    x = images_u8.float() - means
    return resize_bicubic(x, out_hw)


def preprocess_on_device_padded(images_u8, valid_hw, pixel_means, out_hw):
    """Mixed-size form: uint8 [B, H_pad, W_pad, 3] decodes padded
    bottom/right to a dataset-global bucket + each sample's valid_hw
    [B, 2] -> float32 [B, H', W', 3].  The per-sample resize matrices
    (``device_augment``'s crop-resize with the valid region as the window)
    never sample the pad, so this equals resizing each image from its
    true size."""
    from pps_tpu_torch.data.device_augment import crop_resize_batch
    means = torch.as_tensor(np.asarray(pixel_means, np.float32).reshape(-1),
                            device=images_u8.device)
    x = images_u8.float() - means
    valid_hw = valid_hw.int()
    zeros = torch.zeros_like(valid_hw[:, 0])
    return crop_resize_batch(x, valid_hw[:, 0], valid_hw[:, 1], zeros, zeros,
                             tuple(out_hw))
