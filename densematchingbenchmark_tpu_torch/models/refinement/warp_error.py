"""Warp-error disparity refinement.

Counterpart of densematchingbenchmark_tpu/models/refinement/warp_error.py:
17-40 (no shipped config builds it): the disparity is upsampled to the
feature maps' size (scaled by the width ratio), the right features are
warped by it, and [left | right | warped | |left - warped| | disparity]
goes through a 3x3 conv + BN + ReLU and six dilated ones (1, 2, 4, 8, 1,
1) to a one-channel residual added to the upsampled disparity, then a
ReLU. Feature maps are channels-last [B, H, W, C]; the disparity
[B, h, w, 1]; the result float32 [B, H, W, 1].
"""

import torch
from torch import nn

from ...ops.interpolate import upsample_2d
from ...ops.warp import inverse_warp_2d
from ..layers import conv_bn_relu, library_conv


class WarpErrorRefinement(nn.Module):
    """``in_planes``: the channels C of each feature map (the first conv
    takes 4 C + 1)."""

    def __init__(self, in_planes, C=16, batch_norm=True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        width = 2 * C
        self.ConvUnit_0 = conv_bn_relu(batch_norm, 4 * in_planes + 1, width,
                                       3, 1, 1, bias=False, dtype=dtype)
        for i, dil in enumerate((1, 2, 4, 8, 1, 1), 1):
            setattr(self, f"ConvUnit_{i}", conv_bn_relu(
                batch_norm, width, width, 3, 1, dil, dil, bias=False,
                dtype=dtype))
        self.Conv_0 = nn.Conv2d(width, 1, 3, padding=1)

    def forward(self, disp, left, right):
        h, w = left.shape[1:3]
        up_disp = upsample_2d(disp, h, w, align_corners=True) * (
            w / disp.shape[2])
        warped = inverse_warp_2d(right, -up_disp)
        error = (left - warped).abs()
        mix = torch.cat([left, right, warped, error, up_disp], dim=-1)
        for i in range(7):
            mix = getattr(self, f"ConvUnit_{i}")(mix)
        res = library_conv(self.Conv_0, mix, self.dtype)
        return torch.relu(res.float() + up_disp)
