"""Soft-argmin disparity regression, and its 2-D form for flow.

Counterpart of densematchingbenchmark_tpu/ops/soft_argmin.py:21-47,
:100-130 (``local_soft_argmin``, AcfNet's windowed predictor) and
:133-164 (``soft_argmax_2d``, the flow models'). With the
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


def local_soft_argmin(cost_volume, max_disp, radius, start_disp=0,
                      dilation=1, radius_dilation=1, alpha=1.0):
    """Soft-argmin over a window of +-``radius`` samples (step
    ``radius_dilation``) around each pixel's argmax: the window's samples
    outside [0, D) score -10000 * alpha, the softmax runs within the
    window and the expectation is over start_disp + index * dilation. Not
    differentiable through the argmax (an eval-time predictor).

    Args:
      cost_volume: [B, D, H, W], D = ceil(max_disp / dilation).

    Returns:
      [B, H, W, 1] float32 disparity map.
    """
    d = cost_volume.shape[1]
    num = (max_disp + dilation - 1) // dilation
    if d != num:
        raise ValueError(f"cost volume D={d} inconsistent with range "
                         f"D={num}")
    cost = cost_volume.float()
    max_index = cost.argmax(dim=1, keepdim=True)            # [B, 1, H, W]
    offsets = torch.arange(-radius * radius_dilation,
                           radius * radius_dilation + 1, radius_dilation,
                           device=cost.device).reshape(1, -1, 1, 1)
    index = max_index + offsets                             # [B, 2r+1, H, W]
    in_range = (index >= 0) & (index <= d - 1)
    clipped = index.clamp(0, d - 1)
    gathered = torch.gather(cost, 1, clipped) * alpha
    masked = torch.where(in_range, gathered,
                         torch.full_like(gathered, -10000.0 * alpha))
    prob = torch.softmax(masked, dim=1)
    values = start_disp + clipped.float() * dilation
    return (prob * values).sum(dim=1)[..., None]


def soft_argmax_2d(score_volume, radius, dilation=1, normalizer=1.0):
    """Expected (u, v) displacement under a float32 softmax of
    ``score_volume / normalizer`` over a local 2-D window.

    Args:
      score_volume: [B, H, W, (2 radius + 1)^2] scores, the window
        row-major in (dy, dx), each offset a multiple of ``dilation``.

    Returns:
      [B, H, W, 2] float32 flow in pixels.
    """
    n = 2 * radius + 1
    if score_volume.shape[-1] != n * n:
        raise ValueError(f"score volume has {score_volume.shape[-1]} "
                         f"entries, radius {radius} needs {n * n}")
    prob = torch.softmax(score_volume.float() / normalizer, dim=-1)
    offs = torch.arange(-radius * dilation, radius * dilation + 1, dilation,
                        device=prob.device, dtype=torch.float32)
    # (dx, dy) of each window entry, row-major (dx varies fastest)
    return prob @ torch.stack([offs.repeat(n), offs.repeat_interleave(n)], -1)
