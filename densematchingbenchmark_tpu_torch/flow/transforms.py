"""Flow-aware sample transforms (numpy, channels-last).

This package's own copy of densematchingbenchmark_tpu/flow/transforms.py:
the geometric augmentations transform the flow's values as well as its
map (a horizontal flip negates u, a vertical one v, a scale multiplies
the vectors, a rotation turns them). Samples are dicts with 'leftImage' /
'rightImage' [H, W, 3] (frames t and t + 1) and optional 'flow'
[H, W, 2]; randomness is an explicit np.random.Generator.
"""

import numpy as np
import torch

from ..ops.interpolate import resize_linear

_IMG_KEYS = ("leftImage", "rightImage")


def random_crop(sample, size, rng):
    h, w = sample["leftImage"].shape[:2]
    th, tw = size
    y1 = int(rng.integers(0, h - th + 1))
    x1 = int(rng.integers(0, w - tw + 1))
    out = dict(sample)
    for k in _IMG_KEYS + ("flow",):
        if sample.get(k) is not None:
            out[k] = sample[k][y1:y1 + th, x1:x1 + tw]
    return out


def random_horizontal_flip(sample, rng, prob=0.5):
    if rng.random() >= prob:
        return sample
    out = dict(sample)
    for k in _IMG_KEYS:
        out[k] = sample[k][:, ::-1].copy()
    if sample.get("flow") is not None:
        flow = sample["flow"][:, ::-1].copy()
        flow[..., 0] *= -1.0
        out["flow"] = flow
    return out


def random_vertical_flip(sample, rng, prob=0.5):
    if rng.random() >= prob:
        return sample
    out = dict(sample)
    for k in _IMG_KEYS:
        out[k] = sample[k][::-1].copy()
    if sample.get("flow") is not None:
        flow = sample["flow"][::-1].copy()
        flow[..., 1] *= -1.0
        out["flow"] = flow
    return out


def scale(sample, factor):
    """Resize images and flow by ``factor``; flow values scale with it."""
    out = dict(sample)
    h, w = sample["leftImage"].shape[:2]
    nh, nw = int(round(h * factor)), int(round(w * factor))

    def resize(a):
        x = torch.from_numpy(np.ascontiguousarray(a))[None]
        return resize_linear(x, (nh, nw), (1, 2), align_corners=False)[
            0].numpy()

    for k in _IMG_KEYS:
        out[k] = resize(sample[k])
    if sample.get("flow") is not None:
        out["flow"] = resize(sample["flow"]) * factor
    return out


def normalize(sample, mean, std):
    out = dict(sample)
    for k in _IMG_KEYS:
        out[k] = (sample[k] - np.asarray(mean, np.float32)) / \
            np.asarray(std, np.float32)
    return out


def pad_to(sample, size):
    """Bottom/right zero-pad images and flow to ``size`` (flow padded with
    NaN so the loss/metrics mask it out)."""
    th, tw = size
    h, w = sample["leftImage"].shape[:2]
    if th < h or tw < w:
        raise ValueError(f"cannot pad {h}x{w} to {th}x{tw}")
    out = dict(sample)
    for k in _IMG_KEYS:
        out[k] = np.pad(sample[k], ((0, th - h), (0, tw - w), (0, 0)))
    if sample.get("flow") is not None:
        out["flow"] = np.pad(sample["flow"],
                             ((0, th - h), (0, tw - w), (0, 0)),
                             constant_values=np.nan)
    return out


def random_rotate(sample, rng, angle, diff_angle=0.0, order=2):
    """Rotate the pair by a random angle (right image by angle + diff);
    flow VECTORS are rotated too, and the differential rotation adds the
    linearized rotational flow field (flow_trans.py:12-66 semantics,
    HWC layout)."""
    if sample.get("flow") is None:
        return sample
    from scipy import ndimage
    applied = float(rng.uniform(-angle, angle))
    diff = float(rng.uniform(-diff_angle, diff_angle))
    angle1, angle2 = applied - diff / 2, applied + diff / 2
    a1 = np.deg2rad(angle1)

    out = dict(sample)
    h, w = sample["leftImage"].shape[:2]
    flow = sample["flow"].astype(np.float32).copy()
    # linearized flow field of the differential rotation
    # (reference rotate_flow: u += (i - h/2)*diff_rad, v -= (j - w/2)*diff_rad)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    drad = np.deg2rad(diff)
    flow[..., 0] = sample["flow"][..., 0] + (yy - h / 2) * drad
    flow[..., 1] = sample["flow"][..., 1] - (xx - w / 2) * drad

    out["leftImage"] = ndimage.rotate(sample["leftImage"], angle1,
                                      axes=(0, 1), reshape=False,
                                      order=order)
    out["rightImage"] = ndimage.rotate(sample["rightImage"], angle2,
                                       axes=(0, 1), reshape=False,
                                       order=order)
    flow = ndimage.rotate(flow, angle1, axes=(0, 1), reshape=False,
                          order=order)
    # rotate the flow vectors themselves
    u, v = flow[..., 0].copy(), flow[..., 1].copy()
    flow[..., 0] = np.cos(a1) * u + np.sin(a1) * v
    flow[..., 1] = -np.sin(a1) * u + np.cos(a1) * v
    out["flow"] = flow
    return out


def random_translate(sample, rng, translation):
    """Shift left/right crops against each other by (±th, ±tw); the
    relative shift adds to the flow (flow_trans.py:166-205)."""
    th_max, tw_max = ((translation, translation)
                      if np.isscalar(translation) else translation)
    h, w = sample["leftImage"].shape[:2]
    tw = int(rng.integers(-tw_max, tw_max + 1))
    th = int(rng.integers(-th_max, th_max + 1))
    if tw == 0 and th == 0:
        return sample
    x1, x2, x3, x4 = max(0, tw), min(w + tw, w), max(0, -tw), min(w - tw, w)
    y1, y2, y3, y4 = max(0, th), min(h + th, h), max(0, -th), min(h - th, h)
    out = dict(sample)
    out["leftImage"] = sample["leftImage"][y1:y2, x1:x2]
    out["rightImage"] = sample["rightImage"][y3:y4, x3:x4]
    if sample.get("flow") is not None:
        flow = sample["flow"][y1:y2, x1:x2].copy()
        flow[..., 0] += tw
        flow[..., 1] += th
        out["flow"] = flow
    return out


def center_cat(sample, size):
    """Center-pad the IMAGES to ``size`` (flow untouched) —
    flow_trans.py:235-274 (CenterCat)."""
    th, tw = size
    h, w = sample["leftImage"].shape[:2]
    pt, pl = (th - h) // 2, (tw - w) // 2
    pb, pr = (th - h) - pt, (tw - w) - pl
    out = dict(sample)
    for k in _IMG_KEYS:
        out[k] = np.pad(sample[k], ((pt, pb), (pl, pr), (0, 0)))
    return out


def _grayscale(img):
    gs = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    return np.repeat(gs[..., None], 3, axis=-1)


def _lerp(a, b, alpha):
    return a + (b - a) * alpha


def saturation(sample, rng, var):
    alpha = float(rng.uniform(0, var))
    out = dict(sample)
    for k in _IMG_KEYS:
        out[k] = _lerp(sample[k], _grayscale(sample[k]), alpha)
    return out


def brightness(sample, rng, var):
    alpha = float(rng.uniform(0, var))
    out = dict(sample)
    for k in _IMG_KEYS:
        out[k] = _lerp(sample[k], np.zeros_like(sample[k]), alpha)
    return out


def contrast(sample, rng, var):
    alpha = float(rng.uniform(0, var))
    out = dict(sample)
    for k in _IMG_KEYS:
        gs = _grayscale(sample[k])
        out[k] = _lerp(sample[k], np.full_like(sample[k], gs.mean()), alpha)
    return out


def color_jitter(sample, rng, brightness_var=0.4, contrast_var=0.4,
                 saturation_var=0.4):
    """Brightness/contrast/saturation in random order
    (flow_trans.py:429-480, ColorJitter/RandomOrder)."""
    ops = []
    if brightness_var:
        ops.append(lambda s: brightness(s, rng, brightness_var))
    if contrast_var:
        ops.append(lambda s: contrast(s, rng, contrast_var))
    if saturation_var:
        ops.append(lambda s: saturation(s, rng, saturation_var))
    for i in rng.permutation(len(ops)):
        sample = ops[i](sample)
    return sample


def make_train_transform(input_shape, mean, std, rotate=None, translate=None,
                         jitter=False, flips=False):
    """rotate: (angle, diff_angle); translate: (th, tw) or scalar;
    jitter: bool/(b, c, s) tuple; flips: random H/V flips."""
    def apply(sample, rng):
        if rotate:
            sample = random_rotate(sample, rng, rotate[0],
                                   rotate[1] if len(rotate) > 1 else 0.0)
        if translate:
            sample = random_translate(sample, rng, translate)
        sample = random_crop(sample, input_shape, rng)
        if flips:
            sample = random_horizontal_flip(sample, rng)
            sample = random_vertical_flip(sample, rng)
        if jitter:
            args = jitter if isinstance(jitter, (tuple, list)) else ()
            sample = color_jitter(sample, rng, *args)
        return normalize(sample, mean, std)
    return apply


def make_eval_transform(input_shape, mean, std):
    def apply(sample, rng=None):
        sample = pad_to(sample, input_shape)
        return normalize(sample, mean, std)
    return apply
