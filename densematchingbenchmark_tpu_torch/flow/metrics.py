"""Optical-flow error metrics: endpoint error and n-px shares.

Counterpart of densematchingbenchmark_tpu/flow/metrics.py: the endpoint
error over the two channels with NaN ground truth masked out (and, for
sparse ground truth, exact zero flow), the mean EPE and the share of
pixels whose error exceeds 1, 2, 3 and 5 px, in percent.
"""

import torch

PX_THRESHOLDS = (1, 2, 3, 5)


def calc_flow_error(est_flow, gt_flow, sparse=False):
    """est / gt: [..., H, W, 2] tensors. Returns {'{n}px': %, 'epe': px}
    as 0-d float32 tensors on their device (0 where no pixel is
    valid)."""
    gt_u, gt_v = gt_flow[..., 0], gt_flow[..., 1]
    est_u, est_v = est_flow[..., 0], est_flow[..., 1]
    mask = ~(torch.isnan(gt_u) | torch.isnan(gt_v))
    if sparse:
        mask = mask & ~((gt_u.abs() < 1e-12) & (gt_v.abs() < 1e-12))
    maskf = mask.float()
    total = maskf.sum()
    denom = total.clamp_min(1.0)
    any_valid = (total >= 1.0).float()
    gt_u = torch.nan_to_num(gt_u) * maskf
    gt_v = torch.nan_to_num(gt_v) * maskf
    epe_map = torch.sqrt((gt_u - est_u * maskf) ** 2
                         + (gt_v - est_v * maskf) ** 2)
    out = {}
    for t in PX_THRESHOLDS:
        frac = ((epe_map > t) & mask).float().sum() / denom
        out[f"{t}px"] = frac * 100.0 * any_valid
    out["epe"] = (epe_map * maskf).sum() / denom * any_valid
    return out
