"""AnyNet's SPN disparity refinement.

Counterpart of densematchingbenchmark_tpu/models/refinement/anynet.py:
22-63. The left image, resized to the disparity's 1/4 resolution
(bilinear, ``align_corners=False``), goes through three conv + BN + ReLU
units (``ConvUnit_0..2``) and a bare conv (``Conv_0``) into three gate
maps of ``spn_planes`` channels each, normalised so that |G1| + |G2| + |G3|
<= 1; ``Conv_1`` lifts the disparity into ``spn_planes`` features, which
the gated scan (ops/spn.py) propagates left to right in float32; ``Conv_2``
reads the residual, added to the disparity in float32 and clamped by a
ReLU. Every conv is a 2-D library call in the compute dtype, as the JAX
package leaves them to XLA; JAX's row-packed ``pack`` (a TPU schedule
with the same parameters) has no counterpart: the builder drops it. The
list comes back best first: the refined disparity, then the inputs
reversed.
"""

import torch
from torch import nn

from ...ops.interpolate import upsample_2d
from ...ops.spn import gate_recurrent_2d, normalize_gates
from ..layers import conv_bn_relu, library_conv


class AnyNetRefinement(nn.Module):
    def __init__(self, spn_planes=8, batch_norm=True, dtype=torch.float32):
        super().__init__()
        sp, self.dtype, self.spn_planes = spn_planes, dtype, spn_planes
        for i in range(3):
            setattr(self, f"ConvUnit_{i}", conv_bn_relu(
                batch_norm, 3 if i == 0 else 2 * sp, 2 * sp, 3, 1, 1,
                bias=False, dtype=dtype))
        self.Conv_0 = nn.Conv2d(2 * sp, 3 * sp, 3, padding=1, bias=False)
        self.Conv_1 = nn.Conv2d(1, sp, 3, padding=1, bias=False)
        self.Conv_2 = nn.Conv2d(sp, 1, 3, padding=1, bias=False)

    def gates(self, left_image, h, w):
        """The normalised gates (G1, G2, G3), each [B, h, w, spn_planes]
        float32, from the left image."""
        g = upsample_2d(left_image, h, w, align_corners=False).to(self.dtype)
        for i in range(3):
            g = getattr(self, f"ConvUnit_{i}")(g)
        g = library_conv(self.Conv_0, g, self.dtype).float()
        return normalize_gates(*torch.split(g, self.spn_planes, -1))

    def forward(self, disps, ref_fms, tgt_fms, left_image, right_image):
        init = disps[-1]
        h, w = init.shape[1:3]
        g1, g2, g3 = self.gates(left_image, h, w)
        feat = library_conv(self.Conv_1, init.to(self.dtype), self.dtype)
        propagated = gate_recurrent_2d(feat.float(), g1, g2, g3)
        res = library_conv(self.Conv_2, propagated.to(self.dtype), self.dtype)
        return [torch.relu(res.float() + init)] + list(disps)[::-1]
