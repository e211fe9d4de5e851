"""Host image decode (counterpart of ``pps_tpu/data/transforms.py``).

Only ``decode_image`` is ported: the training augmentation runs on the
device (``data/device_augment.py``), and the host augmentation chain the
JAX package keeps as its reference waits for ROADMAP slice 3b.  cv2 is
imported when an image is decoded, never at import; callers without cv2
pass their own ``decode_fn`` to the loader and the test engine.
"""


def decode_image(path):
    """cv2.imread: BGR uint8 [H, W, 3], the reference's decode."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            'decode_image needs OpenCV (cv2), which is not installed; pass '
            'a decode_fn(path) -> uint8 [H, W, 3] BGR array instead') from e
    im = cv2.imread(path)
    if im is None:
        raise IOError('Failed to read image {!r}'.format(path))
    return im
