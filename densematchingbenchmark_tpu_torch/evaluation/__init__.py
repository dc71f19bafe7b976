"""Evaluation of the port: metrics on the device, the evaluation loop and
the metric table (counterparts of densematchingbenchmark_tpu/evaluation/)."""

from .eval_loop import evaluate, make_eval_metrics_step
from .format import combine_shard_metrics, metrics_table
from .metrics import (PX_THRESHOLDS, calc_error, calc_error_with_occlusion,
                      occlusion_mask, remove_padding)

__all__ = ["evaluate", "make_eval_metrics_step", "combine_shard_metrics",
           "metrics_table", "PX_THRESHOLDS", "calc_error",
           "calc_error_with_occlusion", "occlusion_mask", "remove_padding"]
