"""Disparity error metrics on the device: EPE, n-px error and the
occlusion split.

Counterpart of densematchingbenchmark_tpu/evaluation/metrics.py:20-117.
Each function is plain torch on the tensors' device and returns tensors
there: reading a value is the caller's choice of sync point (the eval loop
reads all of them once, at its end).
"""

import torch

from ..ops.warp import inverse_warp_2d

PX_THRESHOLDS = (1, 2, 3, 5)


def calc_error(est_disp, gt_disp, lb=None, ub=None, extra_mask=None,
               per_sample=False):
    """EPE and the {1,2,3,5}-px error in percent over the GT pixels in
    (lb, ub), AND ``extra_mask``.

    With ``per_sample`` every axis but the leading batch axis is reduced,
    giving [B] tensors, so that batched evaluation averages exactly as a
    batch-1 loop does. A sample with no valid pixel scores zeros.

    Returns {'1px', '2px', '3px', '5px', 'epe'}: 0-d (or [B]) float32
    tensors on the inputs' device.
    """
    dims = tuple(range(1 if per_sample else 0, gt_disp.dim()))
    mask = torch.ones_like(gt_disp, dtype=torch.bool)
    if lb is not None:
        mask = mask & (gt_disp > lb)
    if ub is not None:
        mask = mask & (gt_disp < ub)
    if extra_mask is not None:
        mask = mask & extra_mask
    maskf = mask.float()
    total = maskf.sum(dims)
    denom = total.clamp_min(1.0)
    any_valid = (total >= 1.0).float()

    abs_error = (gt_disp.float() - est_disp.float()).abs() * maskf
    out = {}
    for t in PX_THRESHOLDS:
        frac = ((abs_error > t) & mask).float().sum(dims) / denom
        out[f"{t}px"] = frac * 100.0 * any_valid
    out["epe"] = abs_error.sum(dims) / denom * any_valid
    return out


def occlusion_mask(ref_gt_disp, target_gt_disp, theta=1.0, eps=1e-6,
                   compat_grid_sample=False):
    """Left-right consistency occlusion mask, 1 = occluded: the right GT
    warped to the left view with -left_disp disagrees by more than
    ``theta``, or the warp landed on padding. [B, H, W, 1] float."""
    warped = inverse_warp_2d(target_gt_disp, -ref_gt_disp,
                             compat_grid_sample=compat_grid_sample)
    occ = ((warped - ref_gt_disp).abs() > theta) | (warped.abs() < eps)
    return occ.to(ref_gt_disp.dtype)


def calc_error_with_occlusion(est_disp, ref_gt_disp, target_gt_disp, lb, ub,
                              per_sample=False, compat_grid_sample=False):
    """``calc_error`` over the occluded and the non-occluded pixels, keys
    prefixed 'occ_' and 'noc_'."""
    occ = occlusion_mask(ref_gt_disp, target_gt_disp,
                         compat_grid_sample=compat_grid_sample) > 0.5
    out = {}
    for prefix, region in (("occ_", occ), ("noc_", ~occ)):
        for key, val in calc_error(est_disp, ref_gt_disp, lb, ub,
                                   extra_mask=region,
                                   per_sample=per_sample).items():
            out[prefix + key] = val
    return out


def remove_padding(x, height, width):
    """Crop eval padding back to the original size (pad was top + right):
    keep the bottom ``height`` rows and the left ``width`` columns of a
    [B, H, W, C] array or tensor."""
    pad_top = x.shape[1] - height
    return x[:, pad_top:, :width, :]
