"""Seeded synthetic stereo scenes: an image pair, one view warped from the
other by a smooth disparity field, and its sparse ground truth.

A scene is a textured canvas (a few random gratings, blurred noise and
a vertical brightness ramp, as a road scene darkens toward the sky) seen
by the left camera, and by the right one through a disparity field that
grows toward the bottom of the frame, as a ground plane does, with a few
smooth bumps where objects stand nearer. Each view gets its own sensor
noise. The ground truth is the field at the left view's pixels, kept on
a random share of the pixels below a horizon row and zero (invalid)
elsewhere, as a projected LiDAR sweep leaves KITTI's. Everything is drawn
from ``numpy.random.default_rng(seed)``.
"""

import numpy as np


def _blur(x, r):
    """Box blur of radius ``r`` along the last two axes of [..., H, W]
    (edge-padded), by running sums."""
    for axis in (-2, -1):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (r + 1, r)
        c = np.cumsum(np.pad(x, pad, mode="edge"), axis=axis)
        n = x.shape[axis]
        hi = np.take(c, np.arange(2 * r + 1, 2 * r + 1 + n), axis=axis)
        lo = np.take(c, np.arange(0, n), axis=axis)
        x = (hi - lo) / (2 * r + 1)
    return x


def disparity_field(rng, h, w, d_min, d_max):
    """[H, W] float32 smooth field in [d_min, d_max]."""
    y = np.linspace(0.0, 1.0, h)[:, None]
    x = np.linspace(0.0, 1.0, w)[None, :]
    field = 0.15 + 0.85 * y ** 1.5 + 0.1 * (x - 0.5) * rng.uniform(-1, 1)
    for _ in range(int(rng.integers(3, 7))):
        cy, cx = rng.uniform(0.3, 1.0), rng.uniform(0.0, 1.0)
        sy, sx = rng.uniform(0.05, 0.2), rng.uniform(0.03, 0.15)
        field = field + rng.uniform(0.1, 0.4) * np.exp(
            -((y - cy) / sy) ** 2 - ((x - cx) / sx) ** 2)
    field = (field - field.min()) / max(np.ptp(field), 1e-6)
    return (d_min + field * (d_max - d_min)).astype(np.float32)


def texture(rng, h, w):
    """[H, W, 3] float32 in 0..255."""
    y = np.arange(h, dtype=np.float32)[:, None]
    x = np.arange(w, dtype=np.float32)[None, :]
    gratings = []
    for _ in range(6):
        fy, fx = rng.uniform(-0.08, 0.08, 2)
        a = fy * y + rng.uniform(0, 2 * np.pi)
        b = fx * x
        # sin(a + b), separable
        gratings.append(np.sin(a) * np.cos(b) + np.cos(a) * np.sin(b))
    amps = rng.uniform(5, 25, (6, 3)).astype(np.float32)
    img = np.stack(gratings, -1) @ amps
    noise = rng.standard_normal((3, h, w), dtype=np.float32)
    img += 60.0 * _blur(noise, 2).transpose(1, 2, 0)
    grain = rng.standard_normal((h, w, 1), dtype=np.float32)
    img += 30.0 * grain * _blur(rng.random((1, h, w), np.float32), 8)[0][
        ..., None]
    ramp = 0.55 + 0.45 * np.linspace(0.0, 1.0, h, dtype=np.float32)
    return (110.0 + img) * ramp[:, None, None]


def scene(seed, h, w, d_min=4.0, d_max=160.0, gt_density=0.3,
          horizon=0.35):
    """{'left', 'right': uint8 [H, W, 3], 'disp': float32 [H, W] (0 where
    invalid)} of scene ``seed``."""
    rng = np.random.default_rng(seed)
    disp = disparity_field(rng, h, w, d_min, d_max)
    margin = int(np.ceil(d_max)) + 2
    canvas = texture(rng, h, w + margin)
    left = canvas[:, :w]
    # right(y, x) sees the point that the left view sees at x + d
    src = np.arange(w, dtype=np.float32)[None, :] + disp
    x0 = np.floor(src).astype(np.int64)
    t = (src - x0)[..., None]
    rows = np.arange(h)[:, None]
    right = canvas[rows, x0] * (1 - t) + canvas[rows, x0 + 1] * t

    def shot(img):
        img = img + 2.0 * rng.standard_normal(img.shape, dtype=np.float32)
        return np.clip(np.rint(img), 0, 255).astype(np.uint8)

    valid = rng.random((h, w)) < gt_density
    valid[:int(horizon * h)] = False
    gt = np.where(valid, disp, 0.0).astype(np.float32)
    return {"left": shot(left), "right": shot(right), "disp": gt}
