"""StereoNet cost aggregation: 4 conv3d + BN + ReLU units and a final
Co=1 conv, at the feature resolution.

Counterpart of densematchingbenchmark_tpu/models/aggregators/stereonet.py:
21-50. The four 32->32 3x3x3 units carry a conv bias and run through the
trunk kernels (layers.ConvUnit: K1 at eval in float32, K4 in training and,
on its tensor-core route, at eval in bfloat16; the bias folded into the
epilogue's shift at eval); the Co=1 ``Conv_0`` is a library call. The cost
stays at the raw volume's resolution (1/8): the refinement upsamples the
disparity. JAX's ``pack`` (a D-packed TPU schedule with the same
parameters) has no counterpart: the builder drops it.

Input: raw difference volume [B, D, H, W, 32] (or a correlation volume,
``in_planes`` 1); output: [cost] with cost
[B, D, H, W] in float32 in every compute dtype, as JAX returns it.
"""

import torch
from torch import nn

from ..layers import ConvUnit, library_conv


class StereoNetAggregator(nn.Module):
    # ``max_disp``, the config's, is unused as in JAX
    def __init__(self, in_planes=32, max_disp=192, num=4, batch_norm=True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype, self.num = dtype, num
        for i in range(num):
            setattr(self, f"ConvUnit_{i}", ConvUnit(
                in_planes if i == 0 else 32, 32, 3, 1, 1, dims=3,
                batch_norm=batch_norm, relu=True, bias=True, dtype=dtype))
        self.Conv_0 = nn.Conv3d(32, 1, 3, padding=1)

    def forward(self, raw_cost):
        x = raw_cost
        for i in range(self.num):
            x = getattr(self, f"ConvUnit_{i}")(x)
        return [library_conv(self.Conv_0, x, self.dtype)[..., 0].float()]
