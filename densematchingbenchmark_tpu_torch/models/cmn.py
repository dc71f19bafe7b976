"""Confidence measurement network (AcfNet adaptive).

Counterpart of densematchingbenchmark_tpu/models/cmn.py:19-52. One small
head per cost volume maps the D-channel cost to a one-channel confidence
cost (a 3x3 conv + BN + ReLU to D/3 channels, then a 1x1 conv), in the
compute dtype on the library's 2-D convs as JAX leaves them to XLA;
sigmoid gives the confidence and variance = alpha * (1 - conf) + beta
modulates the focal loss's GT distribution. The NLL loss on the
confidence costs is computed outside the module
(losses/disp_losses.conf_nll_loss).
"""

import torch
from torch import nn

from .layers import conv_bn_relu, library_conv


class ConfHead(nn.Module):
    """cost [B, D, H, W] -> float32 confidence cost [B, H, W, 1]."""

    def __init__(self, in_planes, batch_norm=True, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        sec = max(in_planes // 3, 1)
        self.ConvUnit_0 = conv_bn_relu(batch_norm, in_planes, sec, 3, 1, 1,
                                       bias=False, dtype=dtype)
        self.Conv_0 = nn.Conv2d(sec, 1, 1, bias=False)

    def forward(self, cost):
        x = self.ConvUnit_0(cost.movedim(1, -1))       # D -> channels
        return library_conv(self.Conv_0, x, self.dtype).float()


class Cmn(nn.Module):
    """costs (one per volume) -> (variances, confs, conf_costs), lists of
    [B, H, W, 1] float32 maps."""

    def __init__(self, in_planes, num, alpha, beta, batch_norm=True,
                 dtype=torch.float32):
        super().__init__()
        self.num, self.alpha, self.beta = num, alpha, beta
        for i in range(num):
            setattr(self, f"ConfHead_{i}", ConfHead(in_planes, batch_norm,
                                                    dtype))

    def forward(self, costs):
        if len(costs) != self.num:
            raise ValueError(f"cmn configured for {self.num} cost volumes, "
                             f"got {len(costs)}")
        conf_costs = [getattr(self, f"ConfHead_{i}")(c)
                      for i, c in enumerate(costs)]
        confs = [torch.sigmoid(c) for c in conf_costs]
        variances = [self.alpha * (1.0 - c) + self.beta for c in confs]
        return variances, confs, conf_costs
