"""Plain float32 PyTorch PSMNet and AcfNet (uniform), eval forward.

The benchmark's own reference: ``torch`` and ``torch.nn.functional``
calls in channels-first layout (NCHW, NCDHW), no kernel, cache or
batching of the program under test, nothing imported from it. It
follows the papers as the DenseMatchingBenchmark configurations build
them:

- PSMNet (Chang & Chen, CVPR 2018, arXiv:1803.08669): the residual
  feature extractor with its 4-branch spatial pyramid pooling to 32
  channels at 1/4 scale; the concatenation cost volume over 48 disparities
  at 1/4 scale; three stacked 3-D hourglasses with their classify heads;
  trilinear upsampling to the full disparity range and frame; soft-argmin
  regression over 0 .. max_disp - 1.
- AcfNet uniform (Zhang et al., AAAI 2020, arXiv:1909.03751): the same
  extractor, volume and hourglasses, a bias on the seven 3-D units outside
  the hourglasses, and the three classified costs upsampled by learned
  ConvTranspose3d(1, 1, 8, stride 4, padding 2) filters in place of the
  trilinear upsample; its confidence network and losses are training-only
  in the uniform variant and not built.

Departures from the papers, as DenseMatchingBenchmark implements them:
the SPP pools are floor-cropped windows of 64, 32, 16 and 8 at 1/4 scale
(the paper's 64, 32, 16, 8 of the 1/4 map, cropped as ``AvgPool2d``
does), the hourglass skips follow the reference code (``pre`` ReLU-ed
after its skip add, ``post`` the sum of the transposed unit and the
skip), BatchNorm runs in eval mode with eps 1e-5, and the soft-argmin
takes the costs as similarities (softmax of +cost).

Parameter names are those of the weights the benchmark draws
(``weights.py``), so one dictionary loads into both sides. ``rounding``
(precision.py) is applied to every convolution's input and weight: the
identity for the reference proper, float8 for the control.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .precision import identity


class Unit(nn.Module):
    """conv (or transposed conv) -> BatchNorm -> optional ReLU; or a bare
    conv when ``bn`` is False (``Conv_0`` then holds its weight)."""

    def __init__(self, cin, cout, k, stride=1, padding=1, dilation=1,
                 dims=2, bias=False, relu=True, transpose=False,
                 output_padding=0, bn=True):
        super().__init__()
        if transpose:
            cls = (nn.ConvTranspose2d, nn.ConvTranspose3d)[dims - 2]
            self.ConvTransposeExact_0 = cls(cin, cout, k, stride, padding,
                                            output_padding=output_padding,
                                            bias=bias)
        else:
            if dilation > 1:
                padding = dilation
            cls = (nn.Conv2d, nn.Conv3d)[dims - 2]
            self.Conv_0 = cls(cin, cout, k, stride, padding, dilation,
                              bias=bias)
        self.BatchNorm_0 = nn.BatchNorm2d(cout, eps=1e-5) if bn else None
        self.relu = relu
        self.transpose = transpose

    def forward(self, x, rounding=identity):
        conv = self.ConvTransposeExact_0 if self.transpose else self.Conv_0
        w = rounding(conv.weight)
        x = rounding(x)
        if self.transpose:
            fn = (F.conv_transpose2d, F.conv_transpose3d)[x.dim() - 4]
            y = fn(x, w, conv.bias, conv.stride, conv.padding,
                   conv.output_padding)
        else:
            fn = (F.conv2d, F.conv3d)[x.dim() - 4]
            y = fn(x, w, conv.bias, conv.stride, conv.padding,
                   conv.dilation)
        bn = self.BatchNorm_0
        if bn is not None:
            y = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight,
                             bn.bias, False, 0.0, bn.eps)
        return torch.relu(y) if self.relu else y


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride, padding, dilation, downsample):
        super().__init__()
        self.ConvUnit_0 = Unit(cin, cout, 3, stride, padding, dilation)
        self.ConvUnit_1 = Unit(cout, cout, 3, 1, padding, dilation,
                               relu=False)
        self.ConvUnit_2 = (Unit(cin, cout, 1, stride, 0, bias=True,
                                relu=False) if downsample else None)

    def forward(self, x, r):
        out = self.ConvUnit_1(self.ConvUnit_0(x, r), r)
        skip = x if self.ConvUnit_2 is None else self.ConvUnit_2(x, r)
        return out + skip


class Backbone(nn.Module):
    """[B, 3, H, W] -> [B, 32, H/4, W/4]."""

    def __init__(self):
        super().__init__()
        self.firstconv = nn.ModuleList([Unit(3, 32, 3, 2), Unit(32, 32, 3),
                                        Unit(32, 32, 3)])

        def layer(cin, cout, blocks, stride, padding, dilation):
            mods = [BasicBlock(cin, cout, stride, padding, dilation,
                               stride != 1 or cin != cout)]
            mods += [BasicBlock(cout, cout, 1, padding, dilation, False)
                     for _ in range(blocks - 1)]
            return nn.ModuleList(mods)

        self.layer1 = layer(32, 32, 3, 1, 1, 1)
        self.layer2 = layer(32, 64, 16, 2, 1, 1)
        self.layer3 = layer(64, 128, 3, 1, 1, 1)
        self.layer4 = layer(128, 128, 3, 1, 2, 2)
        self.branch_convs = nn.ModuleList([Unit(128, 32, 1, 1, 0)
                                           for _ in range(4)])
        self.pools = (64, 32, 16, 8)
        self.lastconv1 = Unit(320, 128, 3)
        self.lastconv2 = nn.Conv2d(128, 32, 1, bias=False)

    def forward(self, x, r):
        for m in self.firstconv:
            x = m(x, r)
        for m in self.layer1:
            x = m(x, r)
        for m in self.layer2:
            x = m(x, r)
        skip = x
        for m in (*self.layer3, *self.layer4):
            x = m(x, r)
        h, w = x.shape[2:]
        branches = []
        for k, conv in zip(self.pools, self.branch_convs):
            k = min(k, h, w)
            b = conv(F.avg_pool2d(x, k, k), r)
            branches.append(F.interpolate(b, (h, w), mode="bilinear",
                                          align_corners=True))
        feat = torch.cat([skip, x, *branches[::-1]], 1)
        feat = self.lastconv1(feat, r)
        return F.conv2d(r(feat), r(self.lastconv2.weight))


def concat_volume(left, right, d):
    """[B, C, H, W] pair -> [B, 2C, d, H, W]: at disparity i the left
    features beside the right ones shifted right by i, zero (both
    halves) in the first i columns."""
    b, c, h, w = left.shape
    vol = left.new_zeros(b, 2 * c, d, h, w)
    for i in range(d):
        vol[:, :c, i, :, i:] = left[..., i:]
        vol[:, c:, i, :, i:] = right[..., :w - i]
    return vol


class Hourglass(nn.Module):
    def __init__(self, c):
        super().__init__()
        c2 = 2 * c
        self.ConvUnit_0 = Unit(c, c2, 3, 2, dims=3)
        self.ConvUnit_1 = Unit(c2, c2, 3, dims=3, relu=False)
        self.ConvUnit_2 = Unit(c2, c2, 3, 2, dims=3)
        self.ConvUnit_3 = Unit(c2, c2, 3, dims=3)
        self.ConvUnit_4 = Unit(c2, c2, 3, 2, dims=3, relu=False,
                               transpose=True, output_padding=1)
        self.ConvUnit_5 = Unit(c2, c, 3, 2, dims=3, relu=False,
                               transpose=True, output_padding=1)

    def forward(self, x, r, presqu=None, postsqu=None):
        out = self.ConvUnit_0(x, r)
        pre = self.ConvUnit_1(out, r)
        pre = torch.relu(pre if postsqu is None else pre + postsqu)
        out = self.ConvUnit_3(self.ConvUnit_2(pre, r), r)
        post = torch.relu(self.ConvUnit_4(out, r)
                          + (pre if presqu is None else presqu))
        return self.ConvUnit_5(post, r), pre, post


class Aggregator(nn.Module):
    """PSMNet's stacked hourglass; ``learned_upsample`` gives AcfNet's."""

    def __init__(self, max_disp, learned_upsample):
        super().__init__()
        bias = learned_upsample
        self.ConvUnit_0 = Unit(64, 32, 3, dims=3, bias=bias)
        self.ConvUnit_1 = Unit(32, 32, 3, dims=3, bias=bias)
        self.ConvUnit_2 = Unit(32, 32, 3, dims=3, bias=bias)
        self.ConvUnit_3 = Unit(32, 32, 3, dims=3, bias=bias, relu=False)
        for i in range(3):
            setattr(self, f"Hourglass3D_{i}", Hourglass(32))
            setattr(self, f"ConvUnit_{4 + i}",
                    Unit(32, 32, 3, dims=3, bias=bias))
            setattr(self, f"Conv_{i}", nn.Conv3d(32, 1, 3, padding=1,
                                                 bias=False))
            if learned_upsample:
                setattr(self, f"ConvTransposeExact_{i}", nn.ConvTranspose3d(
                    1, 1, 8, stride=4, padding=2, bias=False))
        self.max_disp = max_disp
        self.learned_upsample = learned_upsample

    def forward(self, vol, r, frame):
        cost0 = self.ConvUnit_1(self.ConvUnit_0(vol, r), r)
        cost0 = self.ConvUnit_3(self.ConvUnit_2(cost0, r), r) + cost0
        out1, pre1, post1 = self.Hourglass3D_0(cost0, r)
        out1 = out1 + cost0
        out2, pre2, post2 = self.Hourglass3D_1(out1, r, pre1, post1)
        out2 = out2 + cost0
        out3, _, _ = self.Hourglass3D_2(out2, r, pre2, post2)
        out3 = out3 + cost0

        def classify(x, i):
            x = getattr(self, f"ConvUnit_{4 + i}")(x, r)
            return F.conv3d(r(x), r(getattr(self, f"Conv_{i}").weight),
                            padding=1)

        cost1 = classify(out1, 0)
        cost2 = classify(out2, 1) + cost1
        cost3 = classify(out3, 2) + cost2
        ups = []
        for i, c in enumerate((cost1, cost2, cost3)):
            if self.learned_upsample:
                w = getattr(self, f"ConvTransposeExact_{i}").weight
                ups.append(F.conv_transpose3d(r(c), r(w), stride=4,
                                              padding=2)[:, 0])
            else:
                ups.append(F.interpolate(c, (self.max_disp, *frame),
                                         mode="trilinear",
                                         align_corners=True)[:, 0])
        return ups[::-1]


class CostProcessor(nn.Module):
    def __init__(self, max_disp, learned_upsample):
        super().__init__()
        self.aggregator = Aggregator(max_disp, learned_upsample)


def soft_argmin(cost, max_disp):
    """[B, D, H, W] similarities -> [B, H, W] expected disparity over
    0 .. max_disp - 1."""
    disp = torch.arange(max_disp, dtype=torch.float32, device=cost.device)
    prob = torch.softmax(cost.float(), dim=1)
    return (prob * disp.view(1, -1, 1, 1)).sum(1)


class StereoReference(nn.Module):
    """PSMNet (``learned_upsample`` False) or AcfNet uniform (True):
    normalized [B, 3, H, W] left and right frames -> the three
    disparities [B, H, W], best first."""

    def __init__(self, max_disp=192, learned_upsample=False):
        super().__init__()
        self.backbone = Backbone()
        self.cost_processor = CostProcessor(max_disp, learned_upsample)
        self.max_disp = max_disp

    def forward(self, left, right, rounding=identity):
        fl = self.backbone(left, rounding)
        fr = self.backbone(right, rounding)
        vol = concat_volume(fl, fr, self.max_disp // 4)
        costs = self.cost_processor.aggregator(vol, rounding,
                                               left.shape[2:])
        return [soft_argmin(c, self.max_disp) for c in costs]


FAMILIES = {"PSMNet": False, "AcfNet-uniform": True}


def build(family, max_disp, weights, device):
    """The reference of ``family`` on ``device`` in eval mode, loaded with
    ``weights`` ({name: tensor}, float32; strict: every name present)."""
    if family not in FAMILIES:
        raise KeyError(f"no reference for {family!r}; one of "
                       f"{sorted(FAMILIES)}")
    model = StereoReference(max_disp, FAMILIES[family])
    state = {k: v for k, v in weights.items()
             if not k.endswith("num_batches_tracked")}
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"reference {family}: weights missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    return model.to(device).eval()
