"""Evaluation helpers.

Counterpart of densematchingbenchmark_tpu/evaluation/metrics.py:110-117;
the error metrics (calc_error, occlusion masks) arrive with the evaluation
slice (ROADMAP.md queue 1 item 4).
"""


def remove_padding(x, height, width):
    """Crop eval padding back to the original size (pad was top + right):
    keep the bottom ``height`` rows and the left ``width`` columns of a
    [B, H, W, C] array or tensor."""
    pad_top = x.shape[1] - height
    return x[:, pad_top:, :width, :]
