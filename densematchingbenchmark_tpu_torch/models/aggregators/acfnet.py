"""AcfNet cost aggregation: the PSMNet trunk with learned upsampling.

Counterpart of densematchingbenchmark_tpu/models/aggregators/acfnet.py:
20-106. The trunk is PSMAggregator's (4 dres units, 3 hourglasses, 3
classify units and their Co=1 convs), with a conv bias on the 7 units
outside the hourglasses, as the reference's AcfNet keeps it; the three
classified costs are upsampled 4x in D, H and W by learned
ConvTranspose3d(1, 1, 8, stride 4, padding 2) convs, a library call as in
JAX (an input-dilated conv there, whose kernel utils/jax_weights.py flips
on the way in). Input: raw cost volume [B, D/4, H/4, W/4, Cv] (2C, or 1
for a correlation volume); output: [up3, up2, up1], [B, D, H, W] each in
the compute dtype, best first. Under a ``volume_sharding`` that splits D
the trunk is PSMAggregator's on this rank's planes, its three costs
gathered before the learned upsample (JAX acfnet.py:32, :60-80).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import channels_first
from .psmnet import PSMAggregator


class AcfAggregator(PSMAggregator):
    def __init__(self, in_planes=64, max_disp=192, batch_norm=True,
                 dtype=torch.float32, volume_sharding=None,
                 strided_sharding=None):
        super().__init__(in_planes, max_disp, batch_norm, dtype=dtype,
                         bias=True, volume_sharding=volume_sharding,
                         strided_sharding=strided_sharding)
        # made in up1, up2, up3 order, as the Flax tree names them
        for i in range(3):
            setattr(self, f"ConvTransposeExact_{i}", nn.ConvTranspose3d(
                1, 1, 8, stride=4, padding=2, bias=False))

    def _up(self, cost, i):
        """[B, d, h, w, 1] -> [B, 4d, 4h, 4w]: (in - 1) * 4 - 4 + 8."""
        weight = getattr(self, f"ConvTransposeExact_{i}").weight
        return F.conv_transpose3d(channels_first(cost),
                                  weight.to(self.dtype), stride=4,
                                  padding=2)[:, 0]

    def forward(self, raw_cost, size=None):
        costs = self.trunk(raw_cost, size)
        up1, up2, up3 = (self._up(c, i) for i, c in enumerate(costs))
        return [up3, up2, up1]
