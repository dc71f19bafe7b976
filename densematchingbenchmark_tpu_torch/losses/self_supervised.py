"""Self-supervised photometric losses: SSIM, left-right consistency masks
and the inverse-warp (unsupervised) loss.

Counterpart of densematchingbenchmark_tpu/losses/self_supervised.py:18-79:
the photometric reconstruction loss of a disparity, a Charbonnier (RMS)
term plus a structural dissimilarity term, between the left view and the
right view warped by the disparity, each view average-pooled to the
disparity's size; the occlusion masks from left-right disparity
consistency. Maps are channels-last [B, H, W, C]. No shipped config
reaches them.
"""

import torch
import torch.nn.functional as F

from ..ops.pooling import adaptive_avg_pool2d
from ..ops.warp import inverse_warp_2d
from .common import masked_mean


def _box3(x):
    """3x3 mean with zero padding (F.avg_pool2d(x, 3, 1, 1)) of a
    channels-last map."""
    out = F.avg_pool2d(x.movedim(-1, 1), 3, stride=1, padding=1,
                       count_include_pad=True)
    return out.movedim(1, -1)


def ssim(x, y, mask=None, c1=0.01 ** 2, c2=0.03 ** 2):
    """Mean structural dissimilarity (1 - SSIM) / 2, clipped to [0, 1];
    over ``mask`` where one is given."""
    mu_x, mu_y = _box3(x), _box3(y)
    sigma_x = _box3(x * x) - mu_x * mu_x
    sigma_y = _box3(y * y) - mu_y * mu_y
    sigma_xy = _box3(x * y) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    d = ((1.0 - num / den) / 2.0).clamp(0.0, 1.0)
    if mask is not None:
        return masked_mean(d, mask)
    return d.mean()


def lr_consistency_mask(est_left_disp, est_right_disp, theta=1.0, eps=1e-6):
    """(left mask, right mask), 1 where a view's disparity agrees within
    ``theta`` with the other view's warped to it (not occluded)."""
    left_from_warp = inverse_warp_2d(est_right_disp, -est_left_disp)
    right_from_warp = inverse_warp_2d(est_left_disp, est_right_disp)
    left_occ = (((left_from_warp - est_left_disp).abs() > theta)
                | (left_from_warp.abs() < eps))
    right_occ = (((right_from_warp - est_right_disp).abs() > theta)
                 | (right_from_warp.abs() < eps))
    return ((~left_occ).to(est_left_disp.dtype),
            (~right_occ).to(est_right_disp.dtype))


def inverse_warp_loss(est_disps, left_image, right_image, weights=None,
                      ssim_weight=0.15, rms_weight=0.85, eps=1e-6,
                      mask=None):
    """{'warp_loss_lvl{i}': 0-d tensor}: per level (``est_disps``: left
    view disparities [B, h, w, 1], best first, or one tensor)
    rms_weight * Charbonnier + ssim_weight * DSSIM between the left image
    and the right one warped by the disparity, both pooled to (h, w)."""
    if not isinstance(est_disps, (list, tuple)):
        est_disps = [est_disps]
    if weights is None:
        weights = [1.0] * len(est_disps)
    out = {}
    for i, disp in enumerate(est_disps):
        h, w = disp.shape[1:3]
        li = adaptive_avg_pool2d(left_image, h, w)
        ri = adaptive_avg_pool2d(right_image, h, w)
        warped = inverse_warp_2d(ri, -disp)
        charb = torch.sqrt((li - warped) ** 2 + eps)
        m = mask if mask is not None else torch.ones_like(li, dtype=torch.bool)
        loss = (rms_weight * masked_mean(charb, m)
                + ssim_weight * ssim(li, warped, m))
        out[f"warp_loss_lvl{i}"] = weights[i] * loss
    return out
