"""Affinity propagation (CSPN) and bilateral filtering.

Counterpart of densematchingbenchmark_tpu/ops/propagation.py:16-98: both
are shift-and-accumulate stencils over zero- (CSPN) or edge-padded
(bilateral) channels-last maps, in plain PyTorch as JAX leaves them to
XLA. No shipped config reaches them.
"""

import itertools
import math

import torch
import torch.nn.functional as F


def _propagate(affinity, x, iterations, kernel_size, dilation, dims):
    """x[i] <- sum_k |a_k|[i] / sum_k |a_k|[i] * x[i + offset_k] over the
    kernel_size^dims taps (row-major), zero outside; x [B, *S, C] with
    ``dims`` spatial axes, affinity [B, *S, kernel_size^dims]."""
    k, d = kernel_size, dilation
    if affinity.shape[-1] != k ** dims:
        raise ValueError(f"affinity has {affinity.shape[-1]} taps, the "
                         f"kernel {k ** dims}")
    aff = affinity.abs()
    aff = aff / aff.sum(-1, keepdim=True)
    pad = (k - 1) // 2 * d
    spatial = x.shape[1:1 + dims]
    for _ in range(iterations):
        xp = F.pad(x, (0, 0) + (pad, pad) * dims)
        out = torch.zeros_like(x)
        for idx, offs in enumerate(itertools.product(range(k), repeat=dims)):
            window = xp[(slice(None),) + tuple(
                slice(o * d, o * d + n) for o, n in zip(offs, spatial))]
            out = out + window * aff[..., idx:idx + 1]
        x = out
    return x


def affinity_propagate_2d(affinity, feature, iterations=1, kernel_size=3,
                          dilation=1):
    """CSPN over a map: affinity [B, H, W, K*K], feature [B, H, W, C]."""
    return _propagate(affinity, feature, iterations, kernel_size, dilation,
                      2)


def affinity_propagate_3d(affinity, volume, iterations=1, kernel_size=3,
                          dilation=1):
    """CSPN-3D over a cost volume: affinity [B, D, H, W, K^3], volume
    [B, D, H, W, C]."""
    return _propagate(affinity, volume, iterations, kernel_size, dilation,
                      3)


def bilateral_filter(disp, image, kernel_size=5, sigma_space=1.5,
                     sigma_color=10.0):
    """Edge-preserving smoothing of ``disp`` [B, H, W, 1] guided by
    ``image`` [B, H, W, C], both edge-padded."""
    k = kernel_size
    p = k // 2
    h, w = disp.shape[1:3]

    def edge_pad(x):
        return F.pad(x.movedim(-1, 1), (p, p, p, p),
                     mode="replicate").movedim(1, -1)
    dp, ip = edge_pad(disp), edge_pad(image)
    num = torch.zeros_like(disp)
    den = torch.zeros_like(disp)
    for dy in range(k):
        for dx in range(k):
            spatial = math.exp(-((dy - p) ** 2 + (dx - p) ** 2) /
                               (2 * sigma_space ** 2))
            diff = ip[:, dy:dy + h, dx:dx + w] - image
            color = torch.exp(-(diff * diff).sum(-1, keepdim=True) /
                              (2 * sigma_color ** 2))
            wgt = spatial * color
            num = num + wgt * dp[:, dy:dy + h, dx:dx + w]
            den = den + wgt
    return num / (den + 1e-8)
