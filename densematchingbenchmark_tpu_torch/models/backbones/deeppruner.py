"""DeepPruner backbones (Best = scale 4, Fast = scale 8).

Counterpart of densematchingbenchmark_tpu/models/backbones/deeppruner.py:
19-97: a PSMNet-style SPP trunk returning (features, [guide features])
per view:
  Best: [B, H/4, W/4, 32], guides [[B, H/2, W/2, 32]]
  Fast: [B, H/8, W/8, 32], guides [[B, H/4, W/4, 64], [B, H/2, W/2, 32]]
The same module (same parameters) runs on both views. Its 2-D
convolutions stay library calls, as the JAX package leaves them to XLA.
"""

import torch
from torch import nn

from ..layers import BasicBlock, conv_bn_relu, library_conv
from ...ops.interpolate import upsample_2d
from ...ops.pooling import avg_pool2d


class _DeepPrunerBackbone(nn.Module):
    fast = False

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
        if self.fast:
            # Fast: layer3 strides again (1/8), no dilation
            self.layer3 = layer(64, 128, 3, 2, 1, 1)
            self.layer4 = layer(128, 128, 3, 1, 1, 1)
            self.branch_pools = (32, 16, 8)
            last_in = 128 + 128 + 32 * 3
        else:
            self.layer3 = layer(64, 128, 3, 1, 1, 1)
            self.layer4 = layer(128, 128, 3, 1, 2, 2)
            self.branch_pools = (64, 32, 16, 8)
            last_in = 64 + 128 + 32 * 4
        self.branch_convs = nn.ModuleList([
            conv_bn_relu(bn, 128, 32, 1, 1, 0, 1, bias=False, dtype=dt)
            for _ in self.branch_pools])
        self.lastconv1 = conv_bn_relu(bn, last_in, 128, 3, 1, 1, 1,
                                      bias=False, dtype=dt)
        self.lastconv2 = nn.Conv2d(128, 32, 1, bias=False)

    def _forward(self, x):
        for m in self.firstconv:
            x = m(x)
        out_2_1 = x
        for m in self.layer1:
            out_2_1 = m(out_2_1)                     # 1/2
        out_4_0 = out_2_1
        for m in self.layer2:
            out_4_0 = m(out_4_0)                     # 1/4
        out_4_1 = out_4_0
        for m in self.layer3:
            out_4_1 = m(out_4_1)                     # 1/4 (Best), 1/8 (Fast)
        out_8 = out_4_1
        for m in self.layer4:
            out_8 = m(out_8)

        h, w = out_8.shape[1], out_8.shape[2]
        branches = [upsample_2d(conv(avg_pool2d(out_8, min(k, h, w))), h, w,
                                align_corners=True)
                    for k, conv in zip(self.branch_pools, self.branch_convs)]
        if self.fast:
            feat = torch.cat([out_4_1, out_8] + branches[::-1], dim=-1)
            guides = [out_4_0, out_2_1]
        else:
            feat = torch.cat([out_4_0, out_8] + branches[::-1], dim=-1)
            guides = [out_2_1]
        feat = library_conv(self.lastconv2, self.lastconv1(feat), self.dtype)
        return feat, guides

    def forward(self, left, right):
        """[B, H, W, 3] images -> ((features, guides), same) per view."""
        return self._forward(left), self._forward(right)


class DeepPrunerBestBackbone(_DeepPrunerBackbone):
    fast = False


class DeepPrunerFastBackbone(_DeepPrunerBackbone):
    fast = True
