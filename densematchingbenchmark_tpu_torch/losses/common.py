"""Shared loss plumbing: multi-scale GT rescaling and masked means.

Counterpart of densematchingbenchmark_tpu/losses/common.py:16-38. The
full-resolution GT disparity [B, H, W, 1] is rescaled to each prediction
level, its values divided by the width ratio, with an average pool for
dense GT and a max pool for sparse GT; GT outside (start_disp,
max_disp / scale) is masked (KITTI encodes invalid pixels as 0).
"""

import torch

from ..ops.pooling import adaptive_avg_pool2d, adaptive_max_pool2d


def rescale_gt(gt_disp, out_h, out_w, sparse=False):
    """GT [B, H, W, 1] -> (GT at (out_h, out_w), scale = W_gt / out_w)."""
    scale = gt_disp.shape[2] / float(out_w)
    if gt_disp.shape[1] == out_h and gt_disp.shape[2] == out_w:
        return gt_disp, 1.0
    pool = adaptive_max_pool2d if sparse else adaptive_avg_pool2d
    return pool(gt_disp / scale, out_h, out_w), scale


def valid_mask(scaled_gt, max_disp_at_scale, start_disp=0):
    """Boolean validity mask (start_disp, max_disp_at_scale), exclusive."""
    return (scaled_gt > start_disp) & (scaled_gt < max_disp_at_scale)


def masked_mean(x, mask):
    """sum(x * mask) / max(count, 1): the reference's safe masked mean."""
    maskf = mask.to(x.dtype)
    return (x * maskf).sum() / torch.clamp_min(maskf.sum(), 1.0)
