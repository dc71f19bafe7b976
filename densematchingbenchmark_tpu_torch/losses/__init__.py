"""Stereo losses of the port (counterparts of densematchingbenchmark_tpu/
losses/): the multi-scale smooth-L1 and GERF losses, AcfNet's stereo focal
and confidence NLL losses, DeepPruner's quantile loss, and the combined
evaluator."""

from .builder import CombinedLossEvaluator, make_loss_evaluator, total_loss
from .disp_losses import (conf_nll_loss, gerf_loss, quantile_loss,
                          smooth_l1_loss)
from .focal import stereo_focal_loss

__all__ = ["CombinedLossEvaluator", "make_loss_evaluator", "total_loss",
           "smooth_l1_loss", "gerf_loss", "conf_nll_loss", "quantile_loss",
           "stereo_focal_loss"]
