"""StereoNet feature backbone: K 5x5 stride-2 convs, 6 residual blocks and
a final 3x3 conv.

Counterpart of densematchingbenchmark_tpu/models/backbones/stereonet.py:
15-42. The same module (same parameters) runs on the left and right
images; its 2-D convolutions are library calls, as the JAX package leaves
them to XLA, computed in ``dtype`` (float32 parameters). The submodules
carry the Flax names: ``downsample_<i>``, ``blocks_<i>`` and ``final``.

Output: [B, H / 2^K, W / 2^K, 32] per view (K = ``downsample_num``).
"""

import torch
from torch import nn

from ..layers import BasicBlock, library_conv


class StereoNetBackbone(nn.Module):
    out_planes = 32   # the channels of each view\'s features

    def __init__(self, in_planes=3, batch_norm=True, downsample_num=3,
                 residual_num=6, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.downsample = nn.ModuleList([
            nn.Conv2d(in_planes if i == 0 else 32, 32, 5, stride=2,
                      padding=2) for i in range(downsample_num)])
        self.blocks = nn.ModuleList([
            BasicBlock(32, 32, 1, 1, 1, batch_norm, dtype=dtype)
            for _ in range(residual_num)])
        self.final = nn.Conv2d(32, 32, 3, padding=1)

    def _forward(self, x):
        x = x.to(self.dtype)
        for conv in self.downsample:
            x = library_conv(conv, x, self.dtype)
        for block in self.blocks:
            x = block(x)
        return library_conv(self.final, x, self.dtype)

    def forward(self, left, right):
        """[B, H, W, 3] images -> ([B, H/8, W/8, 32], same) features."""
        return self._forward(left), self._forward(right)
