"""PSMNet cost aggregation: 3 stacked 3-D hourglasses + classify heads.

Counterpart of densematchingbenchmark_tpu/models/aggregators/psmnet.py.
Input: raw cost volume [B, D/4, H/4, W/4, Cv] (``in_planes`` Cv: 2C = 64
for the concatenation volume, 1 for a correlation volume); output: 3 cost
volumes [B, max_disp, H, W] (or [B, D/4, H/4, W/4] with
``return_low_res``), best (deepest) first.

The 13 stride-1 conv+BN(+ReLU) units (4 dres, 2 per hourglass, 3 classify)
run through the trunk kernels (layers.ConvUnit: K1 at eval in float32, K4
in training and, on its tensor-core route, at eval in bfloat16); the
stride-2 and transposed convs of the hourglasses and the three Co=1
classify convs stay library calls (F.conv3d / F.conv_transpose3d), as the
JAX package leaves them to XLA. Everything computes in ``dtype``, the
full-resolution volumes too (JAX aggregators/psmnet.py:118-124); the
soft-argmin promotes them to float32.

With a ``volume_sharding`` that splits D over a model axis (JAX's
``volume_sharding``; its ``strided_sharding``, D whole, is where the port
gathers) the trunk takes this rank's planes of the raw volume, as JAX's
pins lay it out (:36-44, :68-101): the four dres units on the rank's
planes, each with one halo plane from each neighbour; D gathered before
the hourglasses, which run on the whole D on every model rank, as do the
skip adds; each classify unit on the rank's planes of its whole-D input
(its halo taken from it), its Co=1 conv after a halo exchange; then the
three classified costs gathered in one call, so that the upsample and
what reads the costs run on the whole D.
"""

import torch
from torch import nn

from ..layers import ConvUnit, DAxis, Hourglass3D
from ...ops.interpolate import upsample_3d


class PSMAggregator(nn.Module):
    def __init__(self, in_planes=64, max_disp=192, batch_norm=True,
                 return_low_res=False, dtype=torch.float32, bias=False,
                 volume_sharding=None, strided_sharding=None):
        super().__init__()
        self.max_disp = max_disp
        self.return_low_res = return_low_res
        self.dtype = dtype
        self.volume_sharding = volume_sharding
        self.strided_sharding = strided_sharding

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

    def trunk(self, raw_cost, size=None):
        """The three classified costs (cost1, cost2, cost3) at the raw
        volume's resolution, [B, D/4, H/4, W/4, 1] each, on the whole D.
        ``size``: the whole D, when ``raw_cost`` holds this rank's planes
        of it (``volume_sharding``)."""
        ax = DAxis(self.volume_sharding, size)
        cost0 = ax.unit(self.ConvUnit_1, ax.unit(self.ConvUnit_0, raw_cost))
        cost0 = ax.unit(self.ConvUnit_3,
                        ax.unit(self.ConvUnit_2, cost0)) + cost0
        cost0 = ax.whole(cost0)

        out1, pre1, post1 = self.Hourglass3D_0(cost0)
        out1 = out1 + cost0
        out2, pre2, post2 = self.Hourglass3D_1(out1, pre1, post1)
        out2 = out2 + cost0
        out3, _, _ = self.Hourglass3D_2(out2, pre2, post2)
        out3 = out3 + cost0

        def classify(x, i):
            x = ax.shard_unit(getattr(self, f"ConvUnit_{4 + i}"), x)
            return ax.conv(getattr(self, f"Conv_{i}"), x, self.dtype)

        cost1 = classify(out1, 0)
        cost2 = classify(out2, 1) + cost1
        cost3 = classify(out3, 2) + cost2
        if ax.mesh is None:
            return cost1, cost2, cost3
        return ax.whole(torch.cat([cost1, cost2, cost3], -1)).split(1, -1)

    def forward(self, raw_cost, size=None):
        h, w = raw_cost.shape[2:4]
        cost1, cost2, cost3 = self.trunk(raw_cost, size)
        costs = [c[..., 0] for c in (cost3, cost2, cost1)]
        if self.return_low_res:
            return costs
        return [upsample_3d(c, self.max_disp, h * 4, w * 4,
                            align_corners=True) for c in costs]
