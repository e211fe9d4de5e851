"""Device and precision policy for every entry point of the port.

Device: entry points take ``device=`` and default to ``torch.device('cuda')``.
Without a CUDA device they raise unless the caller asked for ``'cpu'``
(as the tests do); nothing carries on quietly on the CPU.

Precision: float32 means float32.  A float32 matrix product or convolution
never runs in TF32 (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are both False, set by
``resolve_device``).  Reduced precision is explicit, as in the JAX package:
with ``MODEL.DTYPE bfloat16`` the conv body casts its input and each weight
to bfloat16 per conv, runs BN arithmetic in float32 and casts back, and the
res5 map is cast to float32 before the head (``models/resnet.py``).
"""

import torch


def resolve_device(device=None):
    """``device`` (default ``'cuda'``) as a torch.device; raises when it
    names CUDA and no CUDA device is present.  Applies the precision
    policy, so every entry point that resolves its device also sets it."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'pps_tpu_torch: no CUDA device is available; pass '
            "device='cpu' to run on the CPU")
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError('unsupported device: {}'.format(dev))
    # full-float32 matmuls and convolutions on the card (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
