"""GCNet feature backbone: a 5x5 stride-2 conv + BN + ReLU, 8 residual
blocks and a 3x3 conv, siamese.

Counterpart of densematchingbenchmark_tpu/models/backbones/gcnet.py:15-35.
The same module (same parameters) runs on the left and right images. Its
2-D convolutions stay library calls, as the JAX package leaves them to
XLA; every unit computes in ``dtype`` (float32 parameters).

Output: [B, H/2, W/2, 32] per view.
"""

import torch
from torch import nn

from ..layers import BasicBlock, conv_bn_relu, library_conv


class GCNetBackbone(nn.Module):
    out_planes = 32   # the channels of each view\'s features

    def __init__(self, in_planes=3, batch_norm=True, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem = conv_bn_relu(batch_norm, in_planes, 32, 5, 2, 2,
                                 dtype=dtype)
        self.blocks = nn.ModuleList([
            BasicBlock(32, 32, 1, 1, 1, batch_norm, dtype=dtype)
            for _ in range(8)])
        self.final = nn.Conv2d(32, 32, 3, padding=1)

    def _forward(self, x):
        x = self.stem(x)
        for block in self.blocks:
            x = block(x)
        return library_conv(self.final, x, self.dtype)

    def forward(self, left, right):
        """[B, H, W, 3] images -> ([B, H/2, W/2, 32], same) features."""
        return self._forward(left), self._forward(right)
