"""AnyNet backbone: a small U-Net giving 1/16, 1/8 and 1/4 feature maps.

Counterpart of densematchingbenchmark_tpu/models/backbones/anynet.py:
16-73. ``conv_init`` is a bare 3x3 conv without a bias, ``conv_down2`` a
stride-2 pre-norm unit (BN -> ReLU -> conv), then three max-pooled levels
of ``block_num`` pre-norm units each (``down_{4,8,16}x``) and two mixing
levels (``mix_{8,4}x``), each on the finer map concatenated with the
coarser one upsampled (bilinear, ``align_corners=False``). Every conv is a
2-D library call in the compute dtype, as the JAX package leaves them to
XLA. The same module (same parameters) runs on both views; the submodules
carry the Flax names (a ``ModuleList`` entry ``down_4x.<i>`` is Flax's
``down_4x_<i>``).

Output per view: [[B, H/16, W/16, 8C], [B, H/8, W/8, 4C], [B, H/4, W/4,
2C]] (C = 1 in the shipped config).
"""

import torch
from torch import nn

from ...ops.interpolate import upsample_2d
from ...ops.pooling import max_pool2d
from ..layers import bn_relu_conv, library_conv


class AnyNetBackbone(nn.Module):
    def __init__(self, in_planes=3, C=1, block_num=2, batch_norm=True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        bn, c = batch_norm, C
        self.conv_init = nn.Conv2d(in_planes, c, 3, padding=1, bias=False)
        self.conv_down2 = bn_relu_conv(bn, c, c, 3, 2, 1, bias=False,
                                       dtype=dtype)

        def blocks(cin, cout, n):
            return nn.ModuleList([
                bn_relu_conv(bn, cin if i == 0 else cout, cout, 3, 1, 1,
                             bias=False, dtype=dtype) for i in range(n)])

        self.down_4x = blocks(c, 2 * c, block_num)
        self.down_8x = blocks(2 * c, 4 * c, block_num)
        self.down_16x = blocks(4 * c, 8 * c, block_num)
        self.mix_8x = blocks(12 * c, 4 * c, 2)
        self.mix_4x = blocks(6 * c, 2 * c, 2)

    @staticmethod
    def _run(units, x):
        for unit in units:
            x = unit(x)
        return x

    def _mix(self, units, fine, coarse):
        up = upsample_2d(coarse, fine.shape[1], fine.shape[2],
                         align_corners=False)
        return self._run(units, torch.cat([fine, up], -1))

    def _forward(self, x):
        x = library_conv(self.conv_init, x.to(self.dtype), self.dtype)
        x = self.conv_down2(x)
        out_4 = self._run(self.down_4x, max_pool2d(x))
        out_8 = self._run(self.down_8x, max_pool2d(out_4))
        out_16 = self._run(self.down_16x, max_pool2d(out_8))
        mix_8 = self._mix(self.mix_8x, out_8, out_16)
        mix_4 = self._mix(self.mix_4x, out_4, mix_8)
        return [out_16, mix_8, mix_4]

    def forward(self, left, right):
        """[B, H, W, 3] images -> ([1/16, 1/8, 1/4 features], same)."""
        return self._forward(left), self._forward(right)
