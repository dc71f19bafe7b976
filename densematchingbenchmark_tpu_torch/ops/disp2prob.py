"""Ground-truth disparity -> probability volume (Laplace, Gaussian,
one-hot).

Counterpart of densematchingbenchmark_tpu/ops/disp2prob.py:17-82. The
stereo focal loss (AcfNet's unimodal supervision) turns the GT disparity
map into a unimodal distribution over the uniform disparity samples (the
JAX functions' ``disp_sample=None``), with a scalar or per-pixel variance
(the confidence network's, AcfNet adaptive). As there, GT outside
(start_disp, start_disp + max_disp - 1) is set to 0 before the distances
are taken and its probability rows become ``EPS``.
"""

import torch

from .cost_volume import disp_sample_tensor

# a float32 subnormal, as in the JAX package: kept, not flushed
EPS = 1e-40


def _prep(gt_disp, max_disp, start_disp, dilation):
    """(GT [B, 1, H, W] masked, mask, samples [1, D, 1, 1]) in float32."""
    gt = (gt_disp[..., 0] if gt_disp.dim() == 4 else gt_disp)[:, None]
    gt = gt.float()
    end_disp = start_disp + max_disp - 1
    mask = ((gt > start_disp) & (gt < end_disp)).float()
    samples = disp_sample_tensor(max_disp, start_disp, dilation, gt.device)
    return gt * mask, mask, samples.reshape(1, -1, 1, 1)


def _variance(variance):
    """A [B, H, W, 1] map -> [B, 1, H, W]; a scalar stays."""
    if torch.is_tensor(variance) and variance.dim() == 4:
        return variance[..., 0][:, None]
    return variance


def laplace_prob(gt_disp, max_disp, variance=1.0, start_disp=0, dilation=1):
    """softmax_D(-|d_s - gt| / variance) * mask + EPS -> [B, D, H, W]."""
    gt, mask, samples = _prep(gt_disp, max_disp, start_disp, dilation)
    cost = -(samples - gt).abs() / _variance(variance)
    return torch.softmax(cost, dim=1) * mask + EPS


def gaussian_prob(gt_disp, max_disp, variance=1.0, start_disp=0, dilation=1):
    """softmax_D(-(d_s - gt)^2 / variance) * mask + EPS."""
    gt, mask, samples = _prep(gt_disp, max_disp, start_disp, dilation)
    cost = -(samples - gt).square() / _variance(variance)
    return torch.softmax(cost, dim=1) * mask + EPS


def onehot_prob(gt_disp, max_disp, variance=1.0, start_disp=0, dilation=1):
    """1 where |d_s - gt| < variance, else 0: no range mask and no EPS,
    as the reference's one-hot variant (``variance`` a scalar or a map
    that broadcasts against [B, D, H, W], as there)."""
    _, _, samples = _prep(gt_disp, max_disp, start_disp, dilation)
    gt = (gt_disp[..., 0] if gt_disp.dim() == 4 else gt_disp)[:, None]
    return ((samples - gt.float()).abs() < variance).float()
