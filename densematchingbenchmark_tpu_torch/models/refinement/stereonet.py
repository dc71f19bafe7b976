"""StereoNet's edge-aware disparity refinement.

Counterpart of densematchingbenchmark_tpu/models/refinement/stereonet.py:
23-78. The coarse disparity is upsampled to the image's resolution
(bilinear, ``align_corners=False``) and its values scaled by the width
ratio; then ``num`` edge-aware blocks each mix [disparity || left image]
through a 3x3 conv + BN + ReLU and 6 dilated residual blocks (dilations 1,
2, 4, 8, 1, 1) into a residual (a Co=1 3x3 conv) added to the disparity
in float32 and clamped by a ReLU. Every conv is a library 2-D conv in the
compute dtype at full resolution, as the JAX package leaves them to XLA;
its row-packed ``pack`` (a TPU schedule with the same parameters) has no
counterpart: the builder drops it. The list comes back best first: the last
refinement, ..., the upsampled initial disparity.
"""

import torch
from torch import nn

from ...ops.interpolate import upsample_2d
from ..layers import BasicBlock, conv_bn_relu, library_conv

DILATIONS = (1, 2, 4, 8, 1, 1)


def upsample_disparity(disp, h, w):
    """[B, h', w', 1] disparity -> [B, h, w, 1], its values scaled by
    w / w' (none where the widths agree)."""
    scale = w / disp.shape[2]
    if scale == 1.0:
        return disp
    return upsample_2d(disp, h, w, align_corners=False) * scale


class EdgeAwareRefinement(nn.Module):
    """(disparity [B, h, w, 1] float32, left image [B, H, W, 3]) ->
    refined disparity [B, H, W, 1] float32."""

    def __init__(self, in_planes=4, batch_norm=True, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ConvUnit_0 = conv_bn_relu(batch_norm, in_planes, 32, 3, 1, 1,
                                       bias=True, dtype=dtype)
        self.BasicBlock = nn.ModuleList([
            BasicBlock(32, 32, 1, 1, d, batch_norm, dtype=dtype)
            for d in DILATIONS])
        self.Conv_0 = nn.Conv2d(32, 1, 3, padding=1)

    def forward(self, disp, left_image):
        h, w = left_image.shape[1:3]
        disp = upsample_disparity(disp, h, w)
        mix = self.ConvUnit_0(torch.cat([disp.to(self.dtype),
                                         left_image.to(self.dtype)], -1))
        for block in self.BasicBlock:
            mix = block(mix)
        res = library_conv(self.Conv_0, mix, self.dtype)
        return torch.relu(res.float() + disp)


class StereoNetRefinement(nn.Module):
    """The cascade: (disps, ref_fms, tgt_fms, left, right) -> [refined
    ``num``, ..., refined 1, upsampled initial], best first."""

    def __init__(self, num=1, batch_norm=True, dtype=torch.float32):
        super().__init__()
        self.EdgeAwareRefinement = nn.ModuleList([
            EdgeAwareRefinement(4, batch_norm, dtype) for _ in range(num)])

    def forward(self, disps, ref_fms, tgt_fms, left_image, right_image):
        h, w = left_image.shape[1:3]
        out = [upsample_disparity(disps[-1], h, w)]
        for block in self.EdgeAwareRefinement:
            out.append(block(out[-1], left_image))
        return out[::-1]
