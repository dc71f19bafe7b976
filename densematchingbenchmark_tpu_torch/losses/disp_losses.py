"""Disparity-map losses.

Counterpart of densematchingbenchmark_tpu/losses/disp_losses.py:19-67,
the smooth-L1 loss of the PSMNet, AcfNet and StereoNet configs, the GERF
loss and AcfNet's confidence NLL loss: multi-scale, each takes the list of
predictions (best first) and the full-resolution GT, rescales the GT per
level and returns a dict of weighted per-level scalars. DeepPruner's
quantile loss (:70-81) is one scalar on its predicted range.
"""

import torch
import torch.nn.functional as F

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


def gerf_loss(est_disps, gt_disp, max_disp, start_disp=0, weights=None,
              sparse=False):
    """Generalized robust error per level -> {'gerf_loss_lvl{i}'}:
    sqrt((gt - est)^2 * mask + 4) / 2 - 1 summed over every pixel (a
    masked one gives exactly 0) over max(valid count, 1)."""
    def level(est):
        sgt, scale = rescale_gt(gt_disp, est.shape[1], est.shape[2], sparse)
        maskf = valid_mask(sgt, max_disp / scale, start_disp).to(est.dtype)
        per_px = torch.sqrt((sgt - est).square() * maskf + 4.0) / 2.0 - 1.0
        return per_px.sum() / torch.clamp_min(maskf.sum(), 1.0)
    return _per_level(est_disps, weights, "gerf_loss", level)


def conf_nll_loss(est_conf_costs, gt_disp, max_disp, start_disp=0,
                  weights=None, sparse=False):
    """-log(sigmoid(conf_cost)) over the valid GT pixels per level ->
    {'conf_loss_lvl{i}'}. Takes the confidence network's pre-sigmoid costs
    [B, H, W, 1]; softplus(-x) is JAX's logaddexp(0, -x)."""
    def level(conf_cost):
        sgt, scale = rescale_gt(gt_disp, conf_cost.shape[1],
                                conf_cost.shape[2], sparse)
        mask = valid_mask(sgt, max_disp / scale, start_disp)
        return masked_mean(F.softplus(-conf_cost), mask)
    return _per_level(est_conf_costs, weights, "conf_loss", level)


def quantile_loss(min_est_disp, max_est_disp, gt_disp, max_disp, start_disp=0,
                  weight=1.0, theta=0.05):
    """DeepPruner's pinball loss pushing min <= GT <= max, over the GT in
    (start_disp, start_disp + max_disp): a scalar."""
    mask = (gt_disp > start_disp) & (gt_disp < start_disp + max_disp)
    diff_min = gt_disp - min_est_disp
    min_term = diff_min * (theta - (diff_min < 0).to(gt_disp.dtype))
    diff_max = gt_disp - max_est_disp
    max_term = diff_max * ((1.0 - theta)
                           - (diff_max < 0).to(gt_disp.dtype))
    return (masked_mean(min_term, mask) + masked_mean(max_term, mask)) \
        * weight
