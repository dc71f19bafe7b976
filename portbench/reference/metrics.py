"""The end-point error, written anew for the reference: the mean
absolute disparity error over the ground-truth pixels inside (lb, ub),
0 for a frame without one."""

import torch


def epe(est, gt, lb=0.0, ub=192.0):
    """est, gt: [H, W] float32 -> the frame's EPE as a Python float."""
    mask = (gt > lb) & (gt < ub)
    n = int(mask.sum())
    if n == 0:
        return 0.0
    return float((est.float() - gt.float()).abs()[mask].sum() / n)


def as_tensor(x, device):
    return torch.as_tensor(x, device=device, dtype=torch.float32)
