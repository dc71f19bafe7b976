"""Visualization of the port: disparity colour maps, error maps and result
saving (counterparts of densematchingbenchmark_tpu/visualization/)."""

from .colormap import disp_err_to_color, disp_map, disp_to_color, group_color
from .save import SaveResultTool

__all__ = ["disp_map", "disp_to_color", "disp_err_to_color", "group_color",
           "SaveResultTool"]
