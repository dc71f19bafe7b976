"""Soft-argmin disparity regression.

Counterpart of densematchingbenchmark_tpu/ops/soft_argmin.py:21-47. With the
uniform sample range (``disp_sample=None``) and ``normalize=True`` this is
the fused softmax-expectation, which runs through the Hopper kernel wrapper
``ops/cuda/soft_argmin_kernel.fused_soft_argmin`` (its plain version on the
CPU); the other cases are plain PyTorch.
"""

import torch

from .cost_volume import disp_sample_tensor
from .cuda.soft_argmin_kernel import fused_soft_argmin


def soft_argmin(cost_volume, disp_sample=None, max_disp=None, start_disp=0,
                dilation=1, alpha=1.0, normalize=True):
    """Expected disparity under softmax(cost * alpha) over the D axis.

    Args:
      cost_volume: [B, D, H, W] matching scores (higher = more similar).
      disp_sample: per-pixel samples [B, D, H, W]; if None, uses the uniform
        range defined by (max_disp, start_disp, dilation).
      alpha: temperature multiplier on the cost.
      normalize: if False, treats cost_volume as already-normalized
        probabilities (no softmax).

    Returns:
      [B, H, W, 1] float32 disparity map.
    """
    if disp_sample is None:
        if max_disp is None:
            raise ValueError("need max_disp when disp_sample is None")
        if normalize:
            return fused_soft_argmin(cost_volume, max_disp, start_disp,
                                     dilation, alpha)
        vals = disp_sample_tensor(max_disp, start_disp, dilation,
                                  cost_volume.device)
        if len(vals) != cost_volume.shape[1]:
            raise ValueError(f"cost volume has {cost_volume.shape[1]} "
                             f"samples, range defines {len(vals)}")
        disp_sample = vals.reshape(1, -1, 1, 1)
    prob = cost_volume.float() * alpha
    if normalize:
        prob = torch.softmax(prob, dim=1)
    return (prob * disp_sample).sum(dim=1)[..., None]
