"""AnyNet: a three-stage coarse-to-fine model with an SPN refinement.

Counterpart of densematchingbenchmark_tpu/models/anynet.py:28-99. Stage 1
(``init_guess``) regresses the disparity at 1/16 from a difference volume
over the full sample range; stages 2 and 3 (``warp_level_8``,
``warp_level_4``) upsample the previous disparity (bilinear,
``align_corners=False``, values scaled by the width ratio), build the
difference volume of the samples start..start + max_disp - 1 centred on
it, and add the regressed residual to it. Every stage, the first too,
builds its volume through the per-pixel warp (ops/cost_volume.dif_volume
with a ``disp_sample``: the reference features masked where the warp
leaves the frame), as JAX's does, and no gradient is stopped between
stages: a warp stage passes gradient to the previous disparity through
the warp's interpolation weights.

Each stage's soft-argmin is over its uniform sample range (JAX's warp
stages pass those same values as ``disp_sample``), so it runs on K2
(``fused_soft_argmin``, its plain version on the CPU); the aggregators'
15 pre-norm units with Co > 1 run on the trunk kernels. The aggregators
carry the Flax names ``agg_<stage>`` at the top level of the module.

Output: {"disps": [refined, d4, d8, d16], "costs": [c4, c8, c16]}, the
disparities at the input's resolution, best first, float32; the costs
[B, D, H, W] at their stage's resolution, float32.
"""

import torch
from torch import nn

from ..ops.cost_volume import dif_volume, disp_sample_tensor
from ..ops.interpolate import upsample_2d
from ..ops.soft_argmin import soft_argmin
from .aggregators.anynet import AnyNetAggregator

STAGES = ("init_guess", "warp_level_8", "warp_level_4")


def upsample_disparity(disp, h, w):
    """[B, h', w', 1] disparity -> [B, h, w, 1], its values scaled by
    w / w' first (JAX's order)."""
    return upsample_2d(disp * (w / disp.shape[2]), h, w, align_corners=False)


class AnyNet(nn.Module):
    def __init__(self, backbone, disp_refinement=None, stage_max_disp=None, stage_start_disp=None,
                 stage_dilation=None, stage_agg_planes=None, agg_num=4,
                 alpha=1.0, batch_norm=True, dtype=torch.float32):
        super().__init__()
        self.backbone = backbone
        self.disp_refinement = disp_refinement
        self.alpha, self.dtype = alpha, dtype
        self.ranges = {st: (stage_max_disp[st], stage_start_disp[st],
                            stage_dilation[st]) for st in STAGES}
        # the backbone's widths at 1/16, 1/8, 1/4 (8C, 4C, 2C)
        c = backbone.conv_init.out_channels
        for st, planes in zip(STAGES, (8 * c, 4 * c, 2 * c)):
            setattr(self, f"agg_{st}", AnyNetAggregator(
                planes, stage_agg_planes[st], agg_num, batch_norm, dtype))

    def _stage(self, st, left, right, prev):
        b, h, w, _ = left.shape
        maxd, start, dilation = self.ranges[st]
        vals = disp_sample_tensor(maxd, start, dilation, left.device)
        samples = vals.reshape(1, -1, 1, 1).expand(b, -1, h, w)
        up = None
        if prev is not None:
            up = upsample_disparity(prev, h, w)
            samples = samples + up[..., 0][:, None]
        raw = dif_volume(left, right, maxd, disp_sample=samples)
        cost = getattr(self, f"agg_{st}")(raw.to(self.dtype))[0]
        # the residual stages regress the offset samples, the first one
        # the absolute values: both the stage's uniform range
        disp = soft_argmin(cost, max_disp=maxd, start_disp=start,
                           dilation=dilation, alpha=self.alpha)
        return cost, disp if up is None else disp + up

    def forward(self, left, right, generator=None):
        """``generator``: the trainer's, for a model that draws noise
        (DeepPruner's PatchMatch); this one draws none."""
        (l16, l8, l4), (r16, r8, r4) = self.backbone(left, right)
        cost16, disp16 = self._stage("init_guess", l16, r16, None)
        cost8, disp8 = self._stage("warp_level_8", l8, r8, disp16)
        cost4, disp4 = self._stage("warp_level_4", l4, r4, disp8)
        disps = [disp4]
        if self.disp_refinement is not None:
            disps = self.disp_refinement(disps, l4, r4, left, right)
        h, w = left.shape[1:3]
        disps = [upsample_disparity(d, h, w) for d in disps + [disp8,
                                                              disp16]]
        return {"disps": disps, "costs": [cost4, cost8, cost16]}
