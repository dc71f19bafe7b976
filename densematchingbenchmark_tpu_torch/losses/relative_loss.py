"""Relative-rank depth loss ("Surface Normals in the Wild").

Counterpart of densematchingbenchmark_tpu/losses/relative_loss.py:17-48.
On valid GT pixels, a label of +1 / -1 takes the soft-margin (logistic)
loss log(1 + exp(-label * diff)) of the signed difference diff = gt - est,
a label of 0 its square; a difference above 66 in magnitude takes |diff|
instead. As in JAX, that branch does not mask the soft-margin term: a
difference whose sign disagrees with its label by more than about 88
overflows exp() and the loss is NaN. No shipped config reaches it.
"""

import torch

from .common import rescale_gt, valid_mask


def relative_loss(est_disps, gt_disp, labels, max_disp, start_disp=0,
                  weights=None, sparse=False):
    """{'relative_loss_lvl{i}': 0-d tensor} over the levels of
    ``est_disps`` ([B, h, w, 1] each, or one tensor); ``labels`` one
    [B, H, W, 1] tensor for every level, or one per level."""
    if not isinstance(est_disps, (list, tuple)):
        est_disps = [est_disps]
    if not isinstance(labels, (list, tuple)):
        labels = [labels] * len(est_disps)
    if weights is None:
        weights = [1.0] * len(est_disps)

    out = {}
    for i, (est, label) in enumerate(zip(est_disps, labels)):
        sgt, scale = rescale_gt(gt_disp, est.shape[1], est.shape[2], sparse)
        mask = valid_mask(sgt, max_disp / scale, start_disp)
        maskf = mask.to(est.dtype)
        diff = (sgt - est) * maskf
        proper = (diff.abs() <= 66.0) & mask
        over = (diff.abs() > 66.0) & mask
        soft_margin = torch.log1p(torch.exp(-label * diff))
        per_px = torch.where(label != 0, soft_margin, diff * diff)
        per_px = (per_px * proper.to(est.dtype)
                  + diff.abs() * over.to(est.dtype))
        denom = torch.clamp_min(maskf.sum(), 1.0)
        out[f"relative_loss_lvl{i}"] = weights[i] * per_px.sum() / denom
    return out
