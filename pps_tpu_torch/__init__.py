"""pps_tpu_torch: the PPS re-ID serving path in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``pps_tpu``, which stays the reference.  Module
names mirror it (``models/resnet.py`` <-> ``pps_tpu/models/resnet.py``), so
a reader looks for a counterpart in the same place.  This package imports
``torch`` and ``numpy`` only: never ``jax`` and nothing of ``pps_tpu``.

Entry points run on the card (``device='cuda'``) unless the caller asks
for the CPU; see ``device.py`` for the device and precision policy.
"""
