"""GeneralizedStereoModel: backbone -> cost processor -> predictor.

Counterpart of densematchingbenchmark_tpu/models/generalized.py:24-84, the
plain branch and the ``fused_upsample_argmin`` branch. The module maps
(left, right) [B, H, W, 3] to {'disps': [...], 'costs': [...]}, best first;
losses live outside it. Refinement, confidence (cmn) and the GCNet
phase-argmin head arrive with their families (ROADMAP.md queue 1).
"""

from torch import nn

from ..ops.cuda.upsample_argmin_kernel import fused_upsample_soft_argmin
from ..ops.interpolate import upsample_3d


class GeneralizedStereoModel(nn.Module):
    def __init__(self, backbone, cost_processor, disp_predictor,
                 fused_upsample_argmin=False, max_disp=192):
        super().__init__()
        self.backbone = backbone
        self.cost_processor = cost_processor
        self.disp_predictor = disp_predictor
        # With an aggregator built in return_low_res mode, fuse the trilinear
        # upsample + soft-argmin into one kernel at eval (the full-res volume
        # is never written; eval 'costs' are then the LOW-RES volumes).
        self.fused_upsample_argmin = fused_upsample_argmin
        self.max_disp = max_disp

    def forward(self, left, right):
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
        return {"disps": disps, "costs": costs}
