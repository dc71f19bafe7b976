"""GCNet 3-D encoder-decoder aggregator (layers 19-37).

Counterpart of densematchingbenchmark_tpu/models/aggregators/gcnet.py:
17-162. Input: the raw volume [B, D, H, W, Cv] (D = max_disp / 2, at half
resolution; Cv = 2C = 64 for the concatenation volume, 1 for a
correlation volume); four stride-2 stages on the dense skip
concatenations, five transposed-conv stages with additive skips, and a
32 -> 1 transposed-conv head: the full-resolution cost [B, 2D, 2H, 2W] in
the compute dtype (the soft-argmin upcasts it).

The ten stride-1 units (c19, c20, c22, c23, c25, c26, c28, c29, c31, c32)
are fusable ``ConvUnit``s and run on the trunk kernels (K1 in float32 eval,
K4's tensor-core route in bfloat16, K4 in training; the 128 -> 128 units
c31 and c32 run the bfloat16 block in two slices of Ci). The strided and
transposed units and the head are library convs, as JAX leaves them to
XLA.

JAX's TPU schedules keep these parameters and compute the same function,
and have no counterpart: ``pack`` (trunk D-packing), ``phase_argmin`` (the
head in phase layout, read by a phase soft-argmin), ``split_concat`` (a
stride-2 unit on a concatenation as two convs over the weight's
input-channel slices) and ``w_pad`` (a masked W padding). The builder
drops them. At eval each intermediate volume is freed as soon as its last
reader has run (c19 before the 19.2 GB ``cat(c18, c20)`` of a 544x960
batch-4 float32 evaluation is made).
"""

import torch
from torch import nn

from ..layers import ConvUnit, library_conv


class GCAggregator(nn.Module):
    """``in_planes``: the raw volume's channels (64 for the concatenation
    of two 32-channel views, 1 for a correlation volume), taken by c19 and
    by c21's concatenation. The widths of every other unit follow from
    JAX's ``in_planes`` field, which its builder never sets: f = 64 // 2
    whatever the volume. ``max_disp``, the config's, is implied by the
    input's D as in JAX."""

    def __init__(self, max_disp=192, in_planes=64, batch_norm=True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        f = 64 // 2
        # (in, out, stride) of c19 .. c32 in order, then c33 .. c36
        convs = [(in_planes, f, 1), (f, f, 1),
                 (in_planes + f, 2 * f, 2), (2 * f, 2 * f, 1),
                 (2 * f, 2 * f, 1),
                 (4 * f, 2 * f, 2), (2 * f, 2 * f, 1), (2 * f, 2 * f, 1),
                 (4 * f, 2 * f, 2), (2 * f, 2 * f, 1), (2 * f, 2 * f, 1),
                 (4 * f, 4 * f, 2), (4 * f, 4 * f, 1), (4 * f, 4 * f, 1)]
        deconvs = [(4 * f, 2 * f), (2 * f, 2 * f), (2 * f, 2 * f),
                   (2 * f, f)]
        for i, (cin, cout, stride) in enumerate(convs):
            setattr(self, f"ConvUnit_{i}", ConvUnit(
                cin, cout, 3, stride, 1, dims=3, batch_norm=batch_norm,
                relu=True, bias=False, dtype=dtype))
        for i, (cin, cout) in enumerate(deconvs, len(convs)):
            setattr(self, f"ConvUnit_{i}", ConvUnit(
                cin, cout, 3, 2, 1, dims=3, batch_norm=batch_norm,
                relu=True, bias=False, transpose=True, output_padding=1,
                dtype=dtype))
        self.ConvTransposeExact_0 = nn.ConvTranspose3d(
            f, 1, 3, 2, 1, output_padding=1)

    def forward(self, raw_cost):
        unit = [getattr(self, f"ConvUnit_{i}") for i in range(18)]
        c19 = unit[0](raw_cost)
        c20 = unit[1](c19)
        del c19
        cat = torch.cat([raw_cost, c20], -1)
        c21 = unit[2](cat)                                    # 1/4
        del cat
        c23 = unit[4](unit[3](c21))
        c24 = unit[5](torch.cat([c21, c23], -1))              # 1/8
        del c21
        c26 = unit[7](unit[6](c24))
        c27 = unit[8](torch.cat([c24, c26], -1))              # 1/16
        del c24
        c29 = unit[10](unit[9](c27))
        c30 = unit[11](torch.cat([c27, c29], -1))             # 1/32
        del c27
        c32 = unit[13](unit[12](c30))
        del c30
        c33 = unit[14](c32)
        c34 = unit[15](c33 + c29)
        c35 = unit[16](c34 + c26)
        c36 = unit[17](c35 + c23)
        c37 = library_conv(self.ConvTransposeExact_0, c36 + c20, self.dtype)
        return [c37[..., 0]]
