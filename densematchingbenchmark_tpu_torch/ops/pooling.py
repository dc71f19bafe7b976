"""Pooling: the SPP branches' average pool, AnyNet's max pool and the GT
rescale of the losses.

Counterpart of densematchingbenchmark_tpu/ops/pooling.py:13-48 and of the
``flax.linen.max_pool`` of JAX's AnyNet backbone
(densematchingbenchmark_tpu/models/backbones/anynet.py:49). Every loss
level's scale factor is an exact integer (static shapes), so adaptive
pooling is a block reduction over a reshape.
"""

import torch.nn.functional as F


def _reshape_pool(x, out_h, out_w, reducer):
    """Pool [B, H, W, C] -> [B, out_h, out_w, C] by exact block reduction."""
    b, h, w, c = x.shape
    if (h, w) == (out_h, out_w):
        return x
    if h % out_h or w % out_w:
        raise ValueError(f"adaptive pool needs an integer ratio, got "
                         f"{h}x{w} -> {out_h}x{out_w}")
    x = x.reshape(b, out_h, h // out_h, out_w, w // out_w, c)
    return reducer(x)


def adaptive_avg_pool2d(x, out_h, out_w):
    """Exact-block average pool (dense GT rescale)."""
    return _reshape_pool(x, out_h, out_w, lambda t: t.mean(dim=(2, 4)))


def adaptive_max_pool2d(x, out_h, out_w):
    """Exact-block max pool (sparse GT rescale: keeps valid pixels alive)."""
    return _reshape_pool(x, out_h, out_w, lambda t: t.amax(dim=(2, 4)))


def avg_pool2d(x, window, stride=None):
    """[B, H, W, C] average pool with window == stride, floor-cropped.

    Matches nn.AvgPool2d((k, k), stride=(k, k)) on the channels-last map:
    rows and columns beyond the last whole window are dropped.
    """
    if stride is None:
        stride = window
    if window != stride:
        raise NotImplementedError("only window == stride pooling is used")
    b, h, w, c = x.shape
    out_h, out_w = h // stride, w // stride
    x = x[:, :out_h * stride, :out_w * stride, :]
    return x.reshape(b, out_h, stride, out_w, stride, c).mean(dim=(2, 4))


def max_pool2d(x, window=2):
    """[B, H, W, C] max pool with window == stride, VALID (floor-cropped):
    ``flax.linen.max_pool(x, (k, k), strides=(k, k))``. The library's pool
    on the channels-last map, whose gradient goes to one maximum of each
    window as JAX's does."""
    return F.max_pool2d(x.movedim(-1, 1), window, window).movedim(
        1, -1).contiguous()
