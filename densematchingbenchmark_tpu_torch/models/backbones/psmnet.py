"""PSMNet feature backbone: firstconv + residual layers + SPP fusion.

Counterpart of densematchingbenchmark_tpu/models/backbones/psmnet.py. The
same module (same parameters) runs on the left and right images. Its 2-D
convolutions stay library calls (F.conv2d), as the JAX package leaves them
to XLA. Every unit computes in ``dtype`` (float32 parameters); the pools
and the SPP resizes keep their input's dtype, as JAX's do.

Output: [B, H/4, W/4, 32] per view.
"""

import torch
from torch import nn

from ..layers import BasicBlock, conv_bn_relu, library_conv
from ...ops.interpolate import upsample_2d
from ...ops.pooling import avg_pool2d


class PSMNetBackbone(nn.Module):
    out_planes = 32   # the channels of each view\'s features

    def __init__(self, in_planes=3, batch_norm=True, dtype=torch.float32):
        super().__init__()
        bn, dt = batch_norm, dtype
        self.dtype = dtype
        self.firstconv = nn.ModuleList([
            conv_bn_relu(bn, in_planes, 32, 3, 2, 1, 1, bias=False, dtype=dt),
            conv_bn_relu(bn, 32, 32, 3, 1, 1, 1, bias=False, dtype=dt),
            conv_bn_relu(bn, 32, 32, 3, 1, 1, 1, bias=False, dtype=dt)])

        def layer(in_planes, out_planes, blocks, stride, padding, dilation):
            mods = [BasicBlock(in_planes, out_planes, stride, padding,
                               dilation, bn,
                               downsample=(stride != 1
                                           or in_planes != out_planes),
                               dtype=dt)]
            mods += [BasicBlock(out_planes, out_planes, 1, padding, dilation,
                                bn, dtype=dt) for _ in range(blocks - 1)]
            return nn.ModuleList(mods)

        self.layer1 = layer(32, 32, 3, 1, 1, 1)
        self.layer2 = layer(32, 64, 16, 2, 1, 1)
        self.layer3 = layer(64, 128, 3, 1, 1, 1)
        self.layer4 = layer(128, 128, 3, 1, 2, 2)

        # SPP branches: avg-pool k, 1x1 conv to 32, bilinear back up
        self.branch_convs = nn.ModuleList([
            conv_bn_relu(bn, 128, 32, 1, 1, 0, 1, bias=False, dtype=dt)
            for _ in range(4)])
        self.branch_pools = (64, 32, 16, 8)

        self.lastconv1 = conv_bn_relu(bn, 320, 128, 3, 1, 1, 1, bias=False,
                                      dtype=dt)
        self.lastconv2 = nn.Conv2d(128, 32, 1, bias=False)

    def _forward(self, x):
        for m in self.firstconv:
            x = m(x)                                 # 1/2
        for m in self.layer1:
            x = m(x)
        out_4_0 = x
        for m in self.layer2:
            out_4_0 = m(out_4_0)                     # 1/4
        out_4_1 = out_4_0
        for m in self.layer3:
            out_4_1 = m(out_4_1)
        out_8 = out_4_1
        for m in self.layer4:
            out_8 = m(out_8)                         # still 1/4 (dilated)

        h, w = out_8.shape[1], out_8.shape[2]
        branches = []
        for k, conv in zip(self.branch_pools, self.branch_convs):
            # clamp the pool window for inputs smaller than the SPP scale
            b = conv(avg_pool2d(out_8, min(k, h, w)))
            branches.append(upsample_2d(b, h, w, align_corners=True))
        # concat order: skip, trunk, branches 4..1
        feat = torch.cat([out_4_0, out_8, branches[3], branches[2],
                          branches[1], branches[0]], dim=-1)
        return library_conv(self.lastconv2, self.lastconv1(feat), self.dtype)

    def forward(self, left, right):
        """[B, H, W, 3] images -> ([B, H/4, W/4, 32], same) features."""
        return self._forward(left), self._forward(right)
