"""Learnable cost-volume normalisation (range, variance, std, sigmoid).

Counterpart of densematchingbenchmark_tpu/models/cost_norm.py:9-59: the
cost is normalised over the disparity axis, then scaled and shifted by a
learnable scalar (weight, bias), or by fixed ones with ``affine=False``.
The variance and std are the unbiased ones (ddof 1), as JAX's.
"""

import torch
from torch import nn

EPS = 1e-5


def range_norm(x, axis=1):
    lo = x.amin(dim=axis, keepdim=True)
    hi = x.amax(dim=axis, keepdim=True)
    return (x - lo) / (hi - lo + EPS)


def var_norm(x, axis=1):
    mean = x.mean(dim=axis, keepdim=True)
    var = x.var(dim=axis, keepdim=True, correction=1)
    return (x - mean).abs() / (var + EPS)


def std_norm(x, axis=1):
    mean = x.mean(dim=axis, keepdim=True)
    std = x.std(dim=axis, keepdim=True, correction=1)
    return (x - mean).abs() / (std + EPS)


def sigmoid_norm(x, axis=1):
    return torch.sigmoid(x)


_NORMS = {"range": range_norm, "var": var_norm, "std": std_norm,
          "sigmoid": sigmoid_norm}


class CostVolumeNorm(nn.Module):
    """norm(x) * weight + bias; ``weight`` and ``bias`` are [1] parameters
    (Flax's ``params/weight``, ``params/bias``) with ``affine``, else the
    fixed ``init_weight`` and ``init_bias``."""

    def __init__(self, kind="range", axis=1, affine=True, init_weight=1.0,
                 init_bias=0.0):
        super().__init__()
        self.norm, self.axis = _NORMS[kind], axis
        if affine:
            self.weight = nn.Parameter(torch.full((1,), float(init_weight)))
            self.bias = nn.Parameter(torch.full((1,), float(init_bias)))
        else:
            self.weight, self.bias = init_weight, init_bias

    def forward(self, x):
        return self.norm(x, self.axis) * self.weight + self.bias
