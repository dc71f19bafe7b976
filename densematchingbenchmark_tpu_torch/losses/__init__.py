"""Stereo losses of the port (counterparts of densematchingbenchmark_tpu/
losses/): the multi-scale smooth-L1 and GERF losses, AcfNet's stereo focal
and confidence NLL losses, and the combined evaluator. The quantile loss
arrives with DeepPruner (ROADMAP.md)."""

from .builder import CombinedLossEvaluator, make_loss_evaluator, total_loss
from .disp_losses import conf_nll_loss, gerf_loss, smooth_l1_loss
from .focal import stereo_focal_loss

__all__ = ["CombinedLossEvaluator", "make_loss_evaluator", "total_loss",
           "smooth_l1_loss", "gerf_loss", "conf_nll_loss",
           "stereo_focal_loss"]
