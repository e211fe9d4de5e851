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

Host-to-device copies: ``Transfer`` (see there).
"""

import numpy as np
import torch

from pps_tpu_torch.utils import trace


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


class Transfer(object):
    """Host numpy arrays -> tensors on ``device``, copied ahead of use.

    On the card ``put`` stages each array in pinned host memory and starts
    a ``non_blocking`` copy on a side stream, so the copy overlaps the
    compute already queued; ``ready`` makes the consumer's stream wait for
    the side stream and records each tensor on it, so the caching
    allocator cannot hand the memory back before the consumer is done.
    On the CPU both are plain conversions."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == 'cuda' else None)

    def put(self, arrays):
        """A dict of arrays (or one array; numpy or CPU tensors) -> the
        same of device tensors, their copies started."""
        with trace.span('transfer.put'):
            one = not isinstance(arrays, dict)
            host = {k: (v.contiguous() if torch.is_tensor(v)
                        else torch.from_numpy(np.ascontiguousarray(v)))
                    for k, v in ({0: arrays} if one else arrays).items()}
            if self._stream is None:
                out = {k: v.to(self.device) for k, v in host.items()}
            else:
                with torch.cuda.stream(self._stream):
                    out = {k: v.pin_memory().to(self.device, non_blocking=True)
                           for k, v in host.items()}
            return out[0] if one else out

    def ready(self, tensors):
        """``tensors`` (a dict or one tensor from ``put``), safe to use on
        the current stream."""
        if self._stream is None:
            return tensors
        cur = torch.cuda.current_stream(self.device)
        cur.wait_stream(self._stream)
        for t in (tensors.values() if isinstance(tensors, dict)
                  else (tensors,)):
            t.record_stream(cur)
        return tensors
