"""Stereo sample transforms (numpy, channels-last).

This package's own copy of densematchingbenchmark_tpu/data/transforms.py
:19-86. Samples are dicts with 'leftImage' / 'rightImage' [H, W, 3] and
optional 'leftDisp' / 'rightDisp' [H, W, 1]. Randomness is an explicit
np.random.Generator. Training: random_crop(input_shape) -> normalize;
inference and evaluation: pad_to (the GT too, for evaluation) or
center_crop -> normalize.
"""

import numpy as np

_SPATIAL_KEYS = ("leftImage", "rightImage", "leftDisp", "rightDisp")


def _crop(sample, y1, x1, th, tw):
    out = dict(sample)
    for k in _SPATIAL_KEYS:
        if sample.get(k) is not None:
            out[k] = sample[k][y1:y1 + th, x1:x1 + tw]
    return out


def random_crop(sample, size, rng):
    h, w = sample["leftImage"].shape[:2]
    th, tw = size
    if (h, w) == (th, tw):
        return sample
    y1 = int(rng.integers(0, h - th + 1))
    x1 = int(rng.integers(0, w - tw + 1))
    return _crop(sample, y1, x1, th, tw)


def center_crop(sample, size):
    h, w = sample["leftImage"].shape[:2]
    th, tw = size
    return _crop(sample, (h - th) // 2, (w - tw) // 2, th, tw)


def pad_to(sample, size, pad_disp=False):
    """Pad top and right with zeros to (th, tw); the images only, unless
    ``pad_disp`` (then the GT too, which padded-pixel masking makes
    equivalent)."""
    h, w = sample["leftImage"].shape[:2]
    th, tw = size
    if (h, w) == (th, tw):
        return sample
    pad = ((th - h, 0), (0, tw - w), (0, 0))
    out = dict(sample)
    keys = ("leftImage", "rightImage") + (
        ("leftDisp", "rightDisp") if pad_disp else ())
    for k in keys:
        if sample.get(k) is not None:
            out[k] = np.pad(sample[k], pad)
    return out


def normalize(sample, mean, std):
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    out = dict(sample)
    for k in ("leftImage", "rightImage"):
        out[k] = (sample[k] - mean) / std
    return out


def make_train_transform(input_shape, mean, std):
    def apply(sample, rng):
        return normalize(random_crop(sample, input_shape, rng), mean, std)
    return apply


def make_eval_transform(input_shape, mean, std, pad_disp=True):
    """pad_to(input_shape) -> normalize; the GT is padded with zeros too,
    which the metrics' lb=0 mask makes invalid, so that samples of mixed
    sizes (KITTI) share one padded shape."""
    def apply(sample, rng=None):
        return normalize(pad_to(sample, input_shape, pad_disp=pad_disp),
                         mean, std)
    return apply
