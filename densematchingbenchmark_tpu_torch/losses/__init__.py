"""Stereo losses of the port (counterparts of densematchingbenchmark_tpu/
losses/): the multi-scale smooth-L1 of the PSMNet configs and the combined
evaluator. The other losses arrive with their families (ROADMAP.md)."""

from .builder import CombinedLossEvaluator, make_loss_evaluator, total_loss
from .disp_losses import smooth_l1_loss

__all__ = ["CombinedLossEvaluator", "make_loss_evaluator", "total_loss",
           "smooth_l1_loss"]
