"""GeneralizedStereoModel: backbone -> cost processor -> predictor
[-> refinement] [-> confidence].

Counterpart of densematchingbenchmark_tpu/models/generalized.py:24-84, the
plain branch, the ``fused_upsample_argmin`` branch, the disparity
refinement (``disp_refinement``, StereoNet's: the disparities come back
at full resolution, best first) and the confidence network (``cmn``,
AcfNet adaptive). The module maps (left, right) [B, H, W, 3] to
{'disps': [...], 'costs': [...]} and, with a cmn, 'variances', 'confs'
and 'conf_costs', best first; losses live outside it. JAX's GCNet
phase-argmin branch (:70-86: the head in phase layout, read by a phase
soft-argmin) is a TPU schedule of the same function: the port's GCNet
returns the full-resolution cost, which the disparity predictor reads
(K2 and its backward kernel).
"""

from torch import nn

from ..ops.cuda.upsample_argmin_kernel import fused_upsample_soft_argmin
from ..ops.interpolate import upsample_3d


class GeneralizedStereoModel(nn.Module):
    def __init__(self, backbone, cost_processor, disp_predictor, cmn=None,
                 disp_refinement=None, fused_upsample_argmin=False,
                 max_disp=192):
        super().__init__()
        self.backbone = backbone
        self.cost_processor = cost_processor
        self.disp_predictor = disp_predictor
        self.cmn = cmn
        self.disp_refinement = disp_refinement
        # With an aggregator built in return_low_res mode, fuse the trilinear
        # upsample + soft-argmin into one kernel at eval (the full-res volume
        # is never written; eval 'costs' are then the LOW-RES volumes).
        self.fused_upsample_argmin = fused_upsample_argmin
        self.max_disp = max_disp

    def forward(self, left, right, generator=None):
        """``generator``: the trainer's, for a model that draws noise
        (DeepPruner's PatchMatch); this one draws none."""
        ref_fms, tgt_fms = self.backbone(left, right)
        costs = self.cost_processor(ref_fms, tgt_fms)
        p = self.disp_predictor
        if self.fused_upsample_argmin and not self.training:
            h, w = left.shape[1:3]
            disps = [fused_upsample_soft_argmin(
                c, self.max_disp, h, w, start_disp=p.start_disp,
                dilation=p.dilation, alpha=p.alpha) for c in costs]
        else:
            if self.fused_upsample_argmin:   # training: upsample, then regress
                h, w = left.shape[1:3]
                costs = [upsample_3d(c, self.max_disp, h, w,
                                     align_corners=True) for c in costs]
            disps = [p(cost) for cost in costs]
        if self.disp_refinement is not None:
            disps = self.disp_refinement(disps, ref_fms, tgt_fms, left, right)
        out = {"disps": disps, "costs": costs}
        if self.cmn is not None:
            variances, confs, conf_costs = self.cmn(costs)
            out.update(variances=variances, confs=confs,
                       conf_costs=conf_costs)
        return out
