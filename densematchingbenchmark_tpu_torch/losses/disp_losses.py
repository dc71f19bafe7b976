"""Disparity-map losses.

Counterpart of densematchingbenchmark_tpu/losses/disp_losses.py:19-37, the
smooth-L1 loss of the PSMNet configs: multi-scale, it takes the list of
predictions (best first) and the full-resolution GT, rescales the GT per
level and returns a dict of weighted per-level scalars. The GERF,
confidence-NLL, focal and quantile losses arrive with their families
(losses/builder.py names their ROADMAP.md items).
"""

import torch

from .common import masked_mean, rescale_gt, valid_mask


def _per_level(est_list, weights, name, fn):
    if not isinstance(est_list, (list, tuple)):
        est_list = [est_list]
    if weights is None:
        weights = [1.0] * len(est_list)
    return {f"{name}_lvl{i}": weights[i] * fn(est)
            for i, est in enumerate(est_list)}


def smooth_l1_loss(est_disps, gt_disp, max_disp, start_disp=0, weights=None,
                   sparse=False):
    """Masked smooth-L1 (Huber, beta 1) per level -> {'l1_loss_lvl{i}'}."""
    def level(est):
        sgt, scale = rescale_gt(gt_disp, est.shape[1], est.shape[2], sparse)
        mask = valid_mask(sgt, max_disp / scale, start_disp)
        diff = (est - sgt).abs()
        huber = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
        return masked_mean(huber, mask)
    return _per_level(est_disps, weights, "l1_loss", level)

