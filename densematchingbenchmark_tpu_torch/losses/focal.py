"""Stereo focal loss: unimodal cross-entropy on the cost volume.

Counterpart of densematchingbenchmark_tpu/losses/focal.py:16-60: the
cross-entropy between log_softmax(cost) and a Laplace GT probability
volume, focally weighted by (1 - P_gt)^(-coefficient), over the valid GT
pixels. The variance may be a scalar (AcfNet uniform) or a per-pixel map
from the confidence network (AcfNet adaptive), one per level; its gradient
reaches the confidence network, as in JAX. The loss runs in float32 on a
bfloat16 cost too.
"""

import torch

from ..ops.disp2prob import laplace_prob
from ..parallel.collectives import global_count
from .common import rescale_gt, valid_mask


def _per_level(x, n):
    return list(x) if isinstance(x, (list, tuple)) else [x] * n


def stereo_focal_loss(est_costs, gt_disp, max_disp, variance, start_disp=0,
                      dilation=1, weights=None, focal_coefficient=0.0,
                      sparse=False):
    """{'stereo_focal_loss_lvl{i}': scalar} over ``est_costs`` ([B, D, h, w]
    each, best first, over the uniform sample range) against the
    full-resolution GT [B, H, W, 1]. ``variance``, ``dilation`` and
    ``weights`` may each be one value or a list per level."""
    if not isinstance(est_costs, (list, tuple)):
        est_costs = [est_costs]
    n = len(est_costs)
    weights = _per_level(1.0 if weights is None else weights, n)
    out = {}
    for i, (cost, var, dil) in enumerate(zip(
            est_costs, _per_level(variance, n), _per_level(dilation, n))):
        _, _, h, w = cost.shape
        sgt, scale = rescale_gt(gt_disp, h, w, sparse)
        maskf = valid_mask(sgt, start_disp + int(max_disp / scale),
                           start_disp).float()
        gt_prob = laplace_prob(sgt * maskf, int(max_disp / scale),
                               variance=var, start_disp=start_disp,
                               dilation=dil)
        log_prob = torch.log_softmax(cost.float(), dim=1)
        focal_w = (1.0 - gt_prob).pow(-focal_coefficient)
        per_px = -(gt_prob * log_prob) * focal_w * maskf[:, None, :, :, 0]
        denom = torch.clamp_min(global_count(maskf.sum()), 1.0)
        out[f"stereo_focal_loss_lvl{i}"] = weights[i] * per_px.sum() / denom
    return out
