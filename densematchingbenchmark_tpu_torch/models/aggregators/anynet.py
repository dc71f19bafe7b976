"""AnyNet cost aggregation: six pre-norm 3x3x3 units (BN -> ReLU -> conv
with a bias), the last with one output channel.

Counterpart of densematchingbenchmark_tpu/models/aggregators/anynet.py:
15-30. The five units with Co > 1 (``ConvUnit_0..4``) run their convs on
the trunk kernels (layers.ConvUnit's pre-norm route: K1 at eval in
float32, K4 in training and, on its tensor-core route, at eval in
bfloat16, with unit scale and the conv bias as the epilogue's shift);
``ConvUnit_5`` (Co = 1) runs the library's conv, as in every family.

Input: raw difference volume [B, D, H, W, C]; output: [cost] with cost
[B, D, H, W] in float32 in every compute dtype, as JAX returns it.
"""

import torch
from torch import nn

from ..layers import bn_relu_conv3d


class AnyNetAggregator(nn.Module):
    def __init__(self, in_planes, agg_planes=4, num=4, batch_norm=True,
                 dtype=torch.float32):
        super().__init__()
        widths = [in_planes] + [agg_planes] * (num + 1) + [1]
        for i in range(num + 2):
            setattr(self, f"ConvUnit_{i}", bn_relu_conv3d(
                batch_norm, widths[i], widths[i + 1], 3, 1, 1, bias=True,
                dtype=dtype))
        self.num = num

    def forward(self, raw_cost):
        x = raw_cost
        for i in range(self.num + 2):
            x = getattr(self, f"ConvUnit_{i}")(x)
        return [x[..., 0].float()]
