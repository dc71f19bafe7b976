"""DeepPruner: differentiable PatchMatch, a confidence range predictor,
uniform samples in the pruned range, aggregation and a cascaded
refinement.

Counterpart of densematchingbenchmark_tpu/models/deeppruner.py:30-260
(ConfidenceRangePredictor, DeepPrunerAggregator, RefinementHead,
DeepPruner). The flow: backbone -> PatchMatch samples over the full range
('pre') -> the predictor's twin H/W-hourglass heads, each read by a
softmax expectation over its samples into a per-pixel min / max
disparity -> uniform samples in the stretched range ('post') ->
aggregation, a softmax expectation, a 2x upsample -> the refinement heads
on the guide features.

The 3x3x3 stride-1 units with BN (20 a forward: the predictor's 4 +
2 x (its hourglass's 3 + 1), the aggregator's 4 + 3 + 1) are fusable
``ConvUnit``s on the trunk kernels; the first unit of each volume takes 2C
+ 1 channels (+ the predictor's 2 x 14 features for the aggregator), which
``route_widths`` pads onto them. The per-pixel softmax expectations are
plain PyTorch, as JAX's are XLA; every other conv is a library call.

Submodules are named after the Flax tree (``ConfidenceRangePredictor_0``,
``DeepPrunerAggregator_0``, ``Conv_0``, ``ConvUnit_0``,
``RefinementHead_<i>``). JAX's TPU schedules with the same parameters and
function have no counterpart: the refinement's row packing (``pack``) and
PatchMatch's ``scoring='corr'`` (models/builder.py drops it: the warped
scores are the same).
"""

import torch
from torch import nn

from .layers import ConvUnit, HWHourglass, conv_bn_relu, library_conv
from ..ops.cost_volume import cat_volume
from ..ops.interpolate import upsample_2d
from ..ops.patch_match import adjust_sample_range, patch_match, \
    uniform_sample


def conv3d_bn_relu(batch_norm, in_features, features, dtype):
    """JAX's ``conv3d_bn_relu(bn, features, 3, 1, 1, bias=False)``."""
    return ConvUnit(in_features, features, 3, 1, 1, dims=3,
                    batch_norm=batch_norm, relu=True, bias=False, dtype=dtype)


def _head(x, hourglass, unit, conv, dtype):
    """An H/W hourglass, a 3x3x3 unit and a Co=1 conv: [B, D, H, W] float32
    cost."""
    return library_conv(conv, unit(hourglass(x)), dtype)[..., 0].float()


def _expectation(cost, samples):
    """softmax over D of the cost, against the per-pixel samples: [B, H, W,
    1]."""
    return (torch.softmax(cost, dim=1) * samples).sum(1)[..., None]


class ConfidenceRangePredictor(nn.Module):
    """raw cost [B, D, H, W, C] + samples [B, D, H, W] -> (min_disp,
    max_disp [B, H, W, 1], min_feat, max_feat [B, D, H, W]), float32."""

    def __init__(self, in_planes, samples, hourglass_in_planes=16,
                 batch_norm=True, dtype=torch.float32):
        super().__init__()
        bn, dt, c = batch_norm, dtype, hourglass_in_planes
        self.dtype = dtype
        for i, (cin, cout) in enumerate(((in_planes, 64), (64, 32), (32, 32),
                                         (32, c))):
            setattr(self, f"ConvUnit_{i}", conv3d_bn_relu(bn, cin, cout, dt))
        self.HWHourglass_0 = HWHourglass(c, bn, dt)
        self.HWHourglass_1 = HWHourglass(c, bn, dt)
        self.ConvUnit_4 = conv3d_bn_relu(bn, c, 2 * c, dt)
        self.ConvUnit_5 = conv3d_bn_relu(bn, c, 2 * c, dt)
        self.Conv_0 = nn.Conv3d(2 * c, 1, 3, padding=1, bias=False)
        self.Conv_1 = nn.Conv3d(2 * c, 1, 3, padding=1, bias=False)
        # the expectations' 5x5 conv + ReLU, in float32 (no BN)
        self.Conv_2 = nn.Conv2d(1, 1, 5, padding=2)
        self.Conv_3 = nn.Conv2d(1, 1, 5, padding=2)
        # the D-channel feature maps of the two costs
        self.ConvUnit_6 = conv_bn_relu(bn, samples, samples, 5, 1, 2,
                                       dtype=dt)
        self.ConvUnit_7 = conv_bn_relu(bn, samples, samples, 5, 1, 2,
                                       dtype=dt)

    def forward(self, raw_cost, disparity_sample):
        cost = raw_cost
        for i in range(4):
            cost = getattr(self, f"ConvUnit_{i}")(cost)
        dt = self.dtype
        cost_min = _head(cost, self.HWHourglass_0, self.ConvUnit_4,
                         self.Conv_0, dt)
        cost_max = _head(cost, self.HWHourglass_1, self.ConvUnit_5,
                         self.Conv_1, dt)
        min_disp, max_disp = (
            torch.relu(library_conv(conv, _expectation(c, disparity_sample),
                                    torch.float32))
            for c, conv in ((cost_min, self.Conv_2),
                            (cost_max, self.Conv_3)))

        def feat(c, unit):
            # channels-last conv over the D axis
            return unit(c.permute(0, 2, 3, 1)).float().permute(0, 3, 1, 2)

        return (min_disp, max_disp, feat(cost_min, self.ConvUnit_6),
                feat(cost_max, self.ConvUnit_7))


class DeepPrunerAggregator(nn.Module):
    """3x3x3 units + an H/W hourglass + a Co=1 conv -> [B, D, H, W] float32
    cost."""

    def __init__(self, in_planes, hourglass_in_planes=16, batch_norm=True,
                 dtype=torch.float32):
        super().__init__()
        bn, dt, c = batch_norm, dtype, hourglass_in_planes
        self.dtype = dtype
        for i, (cin, cout) in enumerate(((in_planes, 64), (64, 32), (32, 32),
                                         (32, c))):
            setattr(self, f"ConvUnit_{i}", conv3d_bn_relu(bn, cin, cout, dt))
        self.HWHourglass_0 = HWHourglass(c, bn, dt)
        self.ConvUnit_4 = conv3d_bn_relu(bn, c, 2 * c, dt)
        self.Conv_0 = nn.Conv3d(2 * c, 1, 3, padding=1, bias=False)

    def forward(self, raw_cost):
        cost = raw_cost
        for i in range(4):
            cost = getattr(self, f"ConvUnit_{i}")(cost)
        cost = self.HWHourglass_0(cost) + cost
        return library_conv(self.Conv_0, self.ConvUnit_4(cost),
                            self.dtype)[..., 0].float()


class RefinementHead(nn.Module):
    """A dilated 2-D conv stack on [guide || disparity] -> a residual; the
    refined disparity ReLU-clamped, float32."""

    STACK = ((32, 1), (32, 1), (32, 1), (16, 2), (16, 4), (16, 1))

    def __init__(self, in_planes, batch_norm=True, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        cin = in_planes
        for i, (planes, dil) in enumerate(self.STACK):
            setattr(self, f"ConvUnit_{i}", conv_bn_relu(
                batch_norm, cin, planes, 3, 1, dil, dil, bias=False,
                dtype=dtype))
            cin = planes
        self.Conv_0 = nn.Conv2d(cin, 1, 3, padding=1, bias=False)

    def forward(self, init_disp, guide):
        x = guide.to(self.dtype)
        for i in range(len(self.STACK)):
            x = getattr(self, f"ConvUnit_{i}")(x)
        res = library_conv(self.Conv_0, x, self.dtype)
        return torch.relu(res.float() + init_disp)


class DeepPruner(nn.Module):
    """(left, right) [B, H, W, 3] -> {'disps': [refined..., post, min, max]
    at full resolution (best first, then the predicted range for the
    quantile loss), 'costs': [], 'min_disparity', 'max_disparity'}.

    ``scale`` is the feature scale of the main stage (4 = Best, 8 = Fast).
    PatchMatch scores the warped float32 features.
    """

    def __init__(self, backbone, max_disp=192, scale=4,
                 patch_match_sample_number=14, uniform_sample_number=9,
                 propagation_filter_size=3, iterations=3, temperature=7.0,
                 hourglass_in_planes=16, refinement_num=1,
                 batch_norm=True, dtype=torch.float32):
        super().__init__()
        bn, dt = batch_norm, dtype
        self.backbone = backbone
        self.max_disp, self.scale, self.dtype = max_disp, scale, dtype
        self.pm_samples = patch_match_sample_number
        self.uni_samples = uniform_sample_number
        self.filter_size, self.iterations = propagation_filter_size, \
            iterations
        self.temperature = float(temperature)
        self.refinement_num = refinement_num
        # both views' 32-channel features and the sample
        raw = 2 * 32 + 1
        self.ConfidenceRangePredictor_0 = ConfidenceRangePredictor(
            raw, patch_match_sample_number, hourglass_in_planes, bn, dt)
        self.DeepPrunerAggregator_0 = DeepPrunerAggregator(
            raw + 2 * patch_match_sample_number, hourglass_in_planes, bn, dt)
        self.Conv_0 = nn.Conv2d(1, 1, 5, padding=2)
        self.ConvUnit_0 = conv_bn_relu(bn, uniform_sample_number,
                                       uniform_sample_number, 5, 1, 2,
                                       dtype=dt)
        # guide channels: Best [1/2: 32 + the cost's feature]; Fast [1/4:
        # 64 + the cost's feature, 1/2: 32], each with the disparity
        guides = (32,) if scale == 4 else (64, 32)
        for i in range(refinement_num):
            cin = guides[i] + 1 + (uniform_sample_number if i == 0 else 0)
            setattr(self, f"RefinementHead_{i}", RefinementHead(cin, bn, dt))

    def _cost(self, ref, tgt, samples, extra=()):
        """The per-pixel concatenation volume [raw || samples || extra
        features broadcast over the samples], in the compute dtype."""
        raw = cat_volume(ref, tgt, self.max_disp, disp_sample=samples)
        shape = raw.shape[:4]
        planes = [raw, samples[..., None]] + [
            f.permute(0, 2, 3, 1)[:, None].expand(*shape, f.shape[1])
            for f in extra]
        return torch.cat(planes, dim=-1).to(self.dtype)

    def forward(self, left, right, generator=None, noise=None):
        """``noise``: optional [B or 1, n, H', W'] PatchMatch noise; else
        in training drawn from ``generator`` (required there, as JAX's
        'patch_match' rng), at eval ``ops.patch_match.eval_noise``."""
        dt = self.dtype
        (ref, ref_guides), (tgt, _) = self.backbone(left, right)
        b, h, w, _ = ref.shape
        feat_max_disp = self.max_disp // self.scale

        # 'pre': PatchMatch over the full range
        if self.training and noise is None and generator is None:
            raise ValueError("DeepPruner in training draws its PatchMatch "
                             "noise from a generator: pass generator= or "
                             "noise=")
        zeros = torch.zeros((b, h, w, 1), dtype=torch.float32,
                            device=ref.device)
        pm = patch_match(ref.float(), tgt.float(), zeros,
                         zeros + feat_max_disp, self.pm_samples,
                         self.filter_size, self.iterations, self.temperature,
                         noise=noise,
                         generator=generator if self.training else None)
        min_d, max_d, min_feat, max_feat = self.ConfidenceRangePredictor_0(
            self._cost(ref, tgt, pm), pm)

        # 'post': uniform samples in the pruned, stretched range
        lo, hi = adjust_sample_range(min_d, max_d, self.uni_samples,
                                     feat_max_disp)
        uni = uniform_sample(lo, hi, self.uni_samples)
        cost = self.DeepPrunerAggregator_0(
            self._cost(ref, tgt, uni, (min_feat, max_feat)))

        # the expectation, upsampled 2x (values doubled), a 5x5 conv
        h2, w2 = 2 * h, 2 * w
        disparity = upsample_2d(_expectation(cost, uni) * 2.0, h2, w2,
                                align_corners=False)
        disparity = torch.relu(library_conv(self.Conv_0, disparity,
                                            torch.float32))
        disp_feature = self.ConvUnit_0(upsample_2d(
            cost.permute(0, 2, 3, 1), h2, w2, align_corners=False))

        # cascaded refinement on guide features || disparity
        disps = [disparity]
        guides = [torch.cat([ref_guides[0].to(dt), disp_feature], -1)] + \
            [g.to(dt) for g in ref_guides[1:]]
        for i in range(self.refinement_num):
            init = disps[-1]
            refined = getattr(self, f"RefinementHead_{i}")(
                init, torch.cat([guides[i], init.to(dt)], -1))
            disps.append(upsample_2d(refined * 2.0, 2 * refined.shape[1],
                                     2 * refined.shape[2],
                                     align_corners=False))
        disps = disps[::-1]                          # best first

        full_h, full_w = left.shape[1:3]

        def to_full(d):
            return upsample_2d(d * (full_w / d.shape[2]), full_h, full_w,
                               align_corners=False)

        disps = [to_full(d) for d in disps]
        min_full, max_full = to_full(min_d), to_full(max_d)
        return {"disps": disps + [min_full, max_full], "costs": [],
                "min_disparity": min_full, "max_disparity": max_full}
