"""Layers of the inventory that no shipped config builds: the 2-D
hourglass, the dilated 3-D hourglass and DenseASPP.

Counterpart of densematchingbenchmark_tpu/models/layers_extra.py:19-128.
Modules take and return the JAX layouts (channels last) and name their
submodules after the Flax tree, so utils/jax_weights.load_jax_variables
carries JAX's variables across.

``DilatedHourglass3D`` is the PSMNet hourglass (``layers.Hourglass3D``):
JAX's has its wiring, units and tree. Its two stride-1 units
(``ConvUnit_1``, ``ConvUnit_3``) run on the trunk kernels as every
fusable unit does: K1 in float32 eval, K4's bfloat16 route in bfloat16,
K4 in training. ``Hourglass2D`` is the same wiring on 2-D maps, every
conv on the library.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (BatchNorm, Hourglass3D, channels_first, channels_last,
                     conv_bn_relu, library_conv)


class Hourglass2D(Hourglass3D):
    """PSMNet's hourglass on [B, H, W, C] maps (C = ``features``): two
    stride-2 downs, two transposed stride-2 ups, pre / post skips.
    Returns (out, pre, post)."""

    dims = 2


class DilatedHourglass3D(Hourglass3D):
    """The 3-D hourglass of the dilated experiments (JAX
    layers_extra.py:44-69): PSMNet's wiring on [B, D, H, W, C] volumes,
    stride 2 on D, H and W. Returns (out, pre, post)."""


def _bn(planes):
    """Flax's ``nn.BatchNorm(momentum=0.9997)`` (torch momentum 3e-4)."""
    return BatchNorm(planes, eps=1e-5, momentum=1.0 - 0.9997)


class DenseAsppBlock(nn.Module):
    """[BN ->] ReLU -> 1x1 conv -> BN -> ReLU -> dilated 3x3 conv
    [-> dropout], in the compute dtype with BN in float32. The leading BN
    only with ``bn_start`` and ``batch_norm``; Flax numbers the BNs and
    convs in creation order."""

    def __init__(self, in_planes, mid_planes, out_planes, dilation,
                 dropout_rate=0.0, bn_start=True, batch_norm=True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype, self.dropout_rate = dtype, dropout_rate
        self.lead = bn_start and batch_norm
        widths = (([in_planes] if self.lead else [])
                  + ([mid_planes] if batch_norm else []))
        for i, planes in enumerate(widths):
            setattr(self, f"BatchNorm_{i}", _bn(planes))
        self.Conv_0 = nn.Conv2d(in_planes, mid_planes, 1)
        self.Conv_1 = nn.Conv2d(mid_planes, out_planes, 3,
                                padding=dilation, dilation=dilation)

    def _norm_relu(self, x, name):
        bn = self._modules.get(name)
        if bn is not None:
            x = channels_last(bn(channels_first(x)))
        return torch.relu(x)

    def forward(self, x):
        x = self._norm_relu(x.to(self.dtype),
                            "BatchNorm_0" if self.lead else None)
        x = library_conv(self.Conv_0, x, self.dtype)
        x = self._norm_relu(x, f"BatchNorm_{int(self.lead)}")
        x = library_conv(self.Conv_1, x, self.dtype)
        if self.dropout_rate > 0:
            x = F.dropout(x, self.dropout_rate, self.training)
        return x


class DenseAspp(nn.Module):
    """Dense ASPP: five dilated blocks (rates 3, 6, 12, 18, 24), each
    input the concatenation of the previous outputs (newest first) and the
    input map, fused back to ``in_planes`` by a 3x3 conv + BN + ReLU and
    projected to ``out_planes`` by a 1x1 conv."""

    def __init__(self, in_planes, out_planes, dropout_rate=0.0,
                 batch_norm=True, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        mid, quarter = in_planes // 2, in_planes // 4
        for i, rate in enumerate((3, 6, 12, 18, 24)):
            setattr(self, f"DenseAsppBlock_{i}", DenseAsppBlock(
                in_planes + i * quarter, mid, quarter, rate, dropout_rate,
                bn_start=(i > 0 and batch_norm), batch_norm=batch_norm,
                dtype=dtype))
        self.ConvUnit_0 = conv_bn_relu(batch_norm, in_planes + 5 * quarter,
                                       in_planes, 3, 1, 1, bias=False,
                                       dtype=dtype)
        self.Conv_0 = nn.Conv2d(in_planes, out_planes, 1, bias=False)

    def forward(self, x):
        feature = x
        for i in range(5):
            out = getattr(self, f"DenseAsppBlock_{i}")(feature)
            feature = torch.cat([out, feature.to(out.dtype)], dim=-1)
        return library_conv(self.Conv_0, self.ConvUnit_0(feature),
                            self.dtype)
