"""Classical confidence measures from cost volumes, and GT confidence.

Counterpart of densematchingbenchmark_tpu/models/conf_measure.py:14-76:
the peak-ratio (PKR), its box-filtered average (APKR) and the non-linear
margin (NLM) from the two largest convex peaks of each pixel's cost over
disparity (a position is a peak where the discrete gradient is positive
into it and negative out of it), and the GT confidence label
|est - gt| < theta on valid GT. Cost volumes are [B, D, H, W], higher
meaning more similar; the measures are [B, 1, H, W].
"""

import torch
import torch.nn.functional as F

EPS = 1e-12


def _local_peaks(cost_volume):
    """(c1, c2) [B, 1, H, W]: the largest and second-largest peak values
    of the cost shifted to a minimum of 0 (0 where there is none)."""
    cv = cost_volume - cost_volume.amin(dim=1, keepdim=True)
    padded = F.pad(cv, (0, 0, 0, 0, 1, 0))
    grad = padded[:, 1:] - padded[:, :-1]
    falls_after = F.pad((grad < 0)[:, 1:].to(torch.uint8), (0, 0, 0, 0, 0, 1),
                        value=1).bool()
    is_peak = (grad > 0) & falls_after
    peak_vals = cv * is_peak.to(cv.dtype)
    c1 = peak_vals.amax(dim=1, keepdim=True)
    removed = peak_vals * (peak_vals < c1).to(cv.dtype)
    c2 = removed.amax(dim=1, keepdim=True)
    return c1, c2


def pkr_confidence(cost_volume):
    """Peak-ratio confidence 1 - |c2 / c1|, in [0, 1]."""
    c1, c2 = _local_peaks(cost_volume)
    return 1.0 - ((c2 + EPS) / (c1 + EPS)).abs()


def apkr_confidence(cost_volume, kernel_size=3):
    """PKR averaged over a ``kernel_size`` window (zero padding), clipped
    to [0, 1]."""
    conf = pkr_confidence(cost_volume)
    p = kernel_size // 2
    out = F.avg_pool2d(F.pad(conf, (p, p, p, p)), kernel_size, stride=1)
    return out.clamp(0.0, 1.0)


def nlm_confidence(cost_volume, sigma=2.0):
    """Non-linear margin exp(-(c2 - c1) / sigma^2)."""
    c1, c2 = _local_peaks(cost_volume)
    return torch.exp(-(c2 - c1) / (sigma ** 2))


def generate_gt_confidence(est_disp, gt_disp, theta=1.0, lb=None, ub=None):
    """1.0 where |est - gt| < theta and the GT is valid (above ``lb``,
    below ``ub``), else 0.0; float32, shaped like the inputs."""
    valid = torch.ones(gt_disp.shape, dtype=torch.bool,
                       device=gt_disp.device)
    if lb is not None:
        valid = valid & (gt_disp > lb)
    if ub is not None:
        valid = valid & (gt_disp < ub)
    return (((est_disp - gt_disp).abs() < theta) & valid).to(torch.float32)
