"""Host image decode and the host augmentation chain, numpy + cv2
(counterpart of ``pps_tpu/data/transforms.py``).

The reference chain, in the reference's order:

  decode BGR -> flip -> random_crop -> horizontal_crop -> hsv_jitter
  -> gaussian_blur -> random_erasing -> (float32, -PIXEL_MEANS)
  -> cv2.resize(REID.SCALE, INTER_CUBIC)

with its quirks kept: hsv_jitter converts with COLOR_RGB2HSV on the BGR
array, random_erasing runs before the resize and fills PIXEL_MEANS in BGR
order, and the means are subtracted before the bicubic resize.  All draws
come from an explicit ``numpy.random.RandomState``, so the same seed gives
the same bytes as the JAX package's chain.  Output is NHWC float32.

The training chain runs on the device (``data/device_augment.py``); this
one serves ``TPU.DEVICE_AUGMENT False``, roidbs without height/width
metadata, and the float32 preprocessing of ``TPU.DEVICE_PREPROC False``
and of mixed-size query groups.  cv2 is imported at first use, never at
import, with ``cv2.setNumThreads(0)`` applied then: cv2's own threads
fight the loader's worker pool, which supplies the parallelism.
"""

import functools
import math

import numpy as np


def _cv2():
    """cv2, its internal threading turned off at the first use."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            'the host image chain needs OpenCV (cv2), which is not '
            'installed; pass a decode_fn(path) -> uint8 [H, W, 3] BGR '
            'array and keep TPU.DEVICE_AUGMENT / TPU.DEVICE_PREPROC on'
        ) from e
    _threads_off(cv2)
    return cv2


@functools.lru_cache(maxsize=1)
def _threads_off(cv2):
    cv2.setNumThreads(0)


def random_crop(im, rng, crop_prob, crop_ratio):
    """A random crop of (crop_ratio .. 1) of each side."""
    if not 0.0 <= crop_prob <= 1.0:
        raise ValueError('crop_prob {} outside [0, 1]'.format(crop_prob))
    if crop_prob == 0 or rng.uniform() > crop_prob:
        return im
    if not 0.0 < crop_ratio < 1.0:
        raise ValueError('crop_ratio {} outside (0, 1)'.format(crop_ratio))
    h_ratio = rng.uniform(crop_ratio, 1)
    w_ratio = rng.uniform(crop_ratio, 1)
    crop_h = int(im.shape[0] * h_ratio)
    crop_w = int(im.shape[1] * w_ratio)
    h_start = rng.randint(0, im.shape[0] - crop_h)
    w_start = rng.randint(0, im.shape[1] - crop_w)
    return im[h_start:h_start + crop_h, w_start:w_start + crop_w, :].copy()


def horizontal_crop(im, rng, prob, ratio):
    """Crop the bottom off tall images; fires only when h / w > 1.5."""
    if (ratio < 1 and prob > 0 and rng.uniform() < prob
            and im.shape[0] * 1.0 / im.shape[1] > 1.5):
        h_ratio = rng.uniform(ratio, 1)
        return im[0:int(im.shape[0] * h_ratio)]
    return im


def hsv_jitter(im, rng, prob, saturation_range, hue_range, value_range):
    """Integer shifts of S, H and V (COLOR_RGB2HSV on the BGR array, the
    reference's quirk), each clipped to [0, 255]."""
    if not 0.0 <= prob <= 1.0:
        raise ValueError('hsv prob {} outside [0, 1]'.format(prob))
    if prob == 0 or rng.uniform() > prob:
        return im
    cv2 = _cv2()
    im_hsv = cv2.cvtColor(im, cv2.COLOR_RGB2HSV).astype(np.int64)
    if saturation_range > 0:
        im_hsv[:, :, 1] += rng.randint(-saturation_range, saturation_range)
    if hue_range > 0:
        im_hsv[:, :, 0] += rng.randint(-hue_range, hue_range)
    if value_range > 0:
        im_hsv[:, :, 2] += rng.randint(-value_range, value_range)
    im_hsv = np.clip(im_hsv, 0, 255).astype(np.uint8)
    return cv2.cvtColor(im_hsv, cv2.COLOR_HSV2RGB)


def gaussian_blur(im, rng, prob, max_kernel):
    """cv2.GaussianBlur with an odd ksize from 1 .. max_kernel - 1."""
    if prob == 0 or rng.uniform() > prob:
        return im
    sizes = list(range(1, max_kernel, 2))
    k = sizes[rng.randint(0, len(sizes))]
    return _cv2().GaussianBlur(im, (k, k), 0)


def random_erasing(im, rng, prob, pixel_means, sl=0.02, sh=0.4, r1=0.3):
    """Random erasing (Zhong et al.) before the resize, filled with the
    means (assigned into the uint8 array, so truncated)."""
    if prob == 0 or rng.uniform(0, 1) > prob:
        return im
    for _ in range(100):
        area = im.shape[0] * im.shape[1]
        target_area = rng.uniform(sl, sh) * area
        aspect_ratio = rng.uniform(r1, 1.0 / r1)
        h = int(round(math.sqrt(target_area * aspect_ratio)))
        w = int(round(math.sqrt(target_area / aspect_ratio)))
        if w < im.shape[1] and h < im.shape[0]:
            x1 = rng.randint(0, im.shape[0] - h + 1)
            y1 = rng.randint(0, im.shape[1] - w + 1)
            im = im.copy()
            for c in range(im.shape[2]):
                im[x1:x1 + h, y1:y1 + w, c] = pixel_means[0, 0, c]
            return im
    return im


def augment(im, rng, cfg):
    """The full training chain in the reference's order (after the
    flip, which the caller applies)."""
    reid = cfg.REID
    im = random_crop(im, rng, reid.CROP_PROB, reid.CROP_RATIO)
    im = horizontal_crop(im, rng, reid.HORIZONTAL_CROP_PROB,
                         reid.HORIZONTAL_CROP_RATIO)
    im = hsv_jitter(im, rng, reid.HSV_JITTER_PROB,
                    int(reid.SATURATION_RANGE), int(reid.HUE_RANGE),
                    int(reid.VALUE_RANGE))
    im = gaussian_blur(im, rng, reid.GAUSSIAN_BLUR_PROB,
                       reid.GAUSSIAN_BLUR_KERNEL)
    im = random_erasing(im, rng, reid.RANDOM_ERASING_PROB,
                        np.asarray(cfg.PIXEL_MEANS),
                        sl=reid.SL, sh=reid.SH, r1=reid.R1)
    return im


def prep_im_for_blob(im, pixel_means, scale_wh):
    """float32, minus the means, bicubic resize to (w, h) = REID.SCALE.
    Returns NHWC float32 [h, w, 3] BGR."""
    cv2 = _cv2()
    im = im.astype(np.float32, copy=False) - pixel_means
    return cv2.resize(im, tuple(scale_wh), interpolation=cv2.INTER_CUBIC)


def decode_image(path):
    """cv2.imread: BGR uint8 [H, W, 3], the reference's decode."""
    im = _cv2().imread(path)
    if im is None:
        raise IOError('Failed to read image {!r}'.format(path))
    return im
