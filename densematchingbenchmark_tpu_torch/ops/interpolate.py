"""Separable linear interpolation (bilinear / trilinear resize).

Counterpart of densematchingbenchmark_tpu/ops/interpolate.py:16-63. The tap
rule is copied exactly (``idx0 = min(floor(x), in - 2)``, weights computed in
float64 and rounded to float32), and each axis is resized in turn with two
gathers and a weighted add, in the same axis order as the reference. The
taps of each (sizes, dtype, device) are made into tensors once and kept
(``axis_taps_tensors``): a copy from the host per call would make every
call on the card wait for the work queued before it.
"""


import numpy as np
import torch

from .kept import kept


def _axis_taps(in_size, out_size, align_corners):
    """(idx0, idx1, w1) numpy arrays for a 1-D linear resize."""
    if out_size == 1:
        x = np.zeros(1)
    elif align_corners:
        x = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    else:
        x = (np.arange(out_size) + 0.5) * in_size / out_size - 0.5
        x = np.clip(x, 0, in_size - 1)
    idx0 = np.floor(x).astype(np.int64)
    idx0 = np.minimum(idx0, in_size - 2) if in_size > 1 else idx0
    w1 = (x - idx0).astype(np.float32)
    return idx0, np.minimum(idx0 + 1, in_size - 1), w1


@kept(256)
def axis_taps_tensors(in_size, out_size, align_corners, dtype, device):
    """``_axis_taps`` as tensors on ``device``, made once per key and kept:
    (idx0, idx1) int64 and w1 in ``dtype``. Callers must not write to them."""
    idx0, idx1, w1 = _axis_taps(in_size, out_size, align_corners)
    # normal tensors even when first made under inference_mode, so that a
    # later training step may save them for its backward
    with torch.inference_mode(False):
        return (torch.as_tensor(idx0, device=device),
                torch.as_tensor(idx1, device=device),
                torch.as_tensor(w1, dtype=dtype, device=device))


def resize_linear(x, out_sizes, axes, align_corners=True):
    """Linear resize of tensor ``x`` along ``axes`` to ``out_sizes``."""
    for axis, out_size in zip(axes, out_sizes):
        in_size = x.shape[axis]
        if in_size == out_size:
            continue
        idx0, idx1, w1 = axis_taps_tensors(in_size, out_size, align_corners,
                                           x.dtype, x.device)
        g0 = x.index_select(axis, idx0)
        g1 = x.index_select(axis, idx1)
        shape = [1] * x.dim()
        shape[axis] = out_size
        w1 = w1.reshape(shape)
        x = g0 * (1 - w1) + g1 * w1
    return x


def upsample_2d(x, out_h, out_w, align_corners=True):
    """[B, H, W, C] -> [B, out_h, out_w, C] bilinear."""
    return resize_linear(x, (out_h, out_w), (1, 2), align_corners)


def upsample_3d(x, out_d, out_h, out_w, align_corners=True):
    """[B, D, H, W(, C)] -> [B, out_d, out_h, out_w(, C)] trilinear."""
    return resize_linear(x, (out_d, out_h, out_w), (1, 2, 3), align_corners)
