"""Core stereo numerics of the port: cost volumes, resizing, pooling,
disparity regression and warps (counterparts of
densematchingbenchmark_tpu/ops/)."""

from .cost_volume import (cat_volume, correlation1d_volume,
                          disp_sample_values)
from .interpolate import resize_linear, upsample_2d, upsample_3d
from .pooling import avg_pool2d
from .soft_argmin import soft_argmin
from .warp import gather_1d_linear, inverse_warp_2d

__all__ = ["cat_volume", "correlation1d_volume", "disp_sample_values",
           "resize_linear", "upsample_2d", "upsample_3d", "avg_pool2d",
           "soft_argmin", "gather_1d_linear", "inverse_warp_2d"]
