"""PSMNet cost aggregation: 3 stacked 3-D hourglasses + classify heads.

Counterpart of densematchingbenchmark_tpu/models/aggregators/psmnet.py.
Input: raw cost volume [B, D/4, H/4, W/4, 2C]; output: 3 cost volumes
[B, max_disp, H, W] (or [B, D/4, H/4, W/4] with ``return_low_res``), best
(deepest) first.

The 13 stride-1 conv+BN(+ReLU) units (4 dres, 2 per hourglass, 3 classify)
run through the trunk kernels (layers.ConvUnit: K1 at eval in float32, K4
in training and, on its tensor-core route, at eval in bfloat16); the
stride-2 and transposed convs of the hourglasses and the three Co=1
classify convs stay library calls (F.conv3d / F.conv_transpose3d), as the
JAX package leaves them to XLA. Everything computes in ``dtype``, the
full-resolution volumes too (JAX aggregators/psmnet.py:118-124); the
soft-argmin promotes them to float32.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import ConvUnit, Hourglass3D, channels_first, channels_last
from ...ops.interpolate import upsample_3d


class PSMAggregator(nn.Module):
    def __init__(self, in_planes=64, max_disp=192, batch_norm=True,
                 return_low_res=False, dtype=torch.float32, bias=False):
        super().__init__()
        self.max_disp = max_disp
        self.return_low_res = return_low_res
        self.dtype = dtype

        # ``bias``: a conv bias on the 7 units outside the hourglasses
        # (AcfNet's aggregator keeps it; PSMNet's has none)
        def unit(cin, relu=True):
            return ConvUnit(cin, 32, 3, 1, 1, dims=3, batch_norm=batch_norm,
                            relu=relu, bias=bias, dtype=dtype)

        self.ConvUnit_0 = unit(in_planes)
        self.ConvUnit_1 = unit(32)
        self.ConvUnit_2 = unit(32)
        self.ConvUnit_3 = unit(32, relu=False)
        for i in range(3):
            setattr(self, f"Hourglass3D_{i}",
                    Hourglass3D(32, batch_norm, dtype))
        for i in range(3):
            setattr(self, f"ConvUnit_{4 + i}", unit(32))
            setattr(self, f"Conv_{i}", nn.Conv3d(32, 1, 3, padding=1,
                                                 bias=False))

    def _classify(self, x, i):
        x = getattr(self, f"ConvUnit_{4 + i}")(x)
        weight = getattr(self, f"Conv_{i}").weight.to(self.dtype)
        return channels_last(F.conv3d(channels_first(x), weight, padding=1))

    def trunk(self, raw_cost):
        """The three classified costs (cost1, cost2, cost3) at the raw
        volume's resolution, [B, D/4, H/4, W/4, 1] each."""
        cost0 = self.ConvUnit_1(self.ConvUnit_0(raw_cost))
        cost0 = self.ConvUnit_3(self.ConvUnit_2(cost0)) + cost0

        out1, pre1, post1 = self.Hourglass3D_0(cost0)
        out1 = out1 + cost0
        out2, pre2, post2 = self.Hourglass3D_1(out1, pre1, post1)
        out2 = out2 + cost0
        out3, _, _ = self.Hourglass3D_2(out2, pre2, post2)
        out3 = out3 + cost0

        cost1 = self._classify(out1, 0)
        cost2 = self._classify(out2, 1) + cost1
        cost3 = self._classify(out3, 2) + cost2
        return cost1, cost2, cost3

    def forward(self, raw_cost):
        b, d, h, w, _ = raw_cost.shape
        cost1, cost2, cost3 = self.trunk(raw_cost)
        costs = [c[..., 0] for c in (cost3, cost2, cost1)]
        if self.return_low_res:
            return costs
        return [upsample_3d(c, self.max_disp, h * 4, w * 4,
                            align_corners=True) for c in costs]
