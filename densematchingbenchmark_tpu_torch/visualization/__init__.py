"""Visualization of the port: disparity colour maps, error maps, result
panels with confidence histograms, and result saving (counterparts of
densematchingbenchmark_tpu/visualization/)."""

from .colormap import disp_err_to_color, disp_map, disp_to_color, group_color
from .save import SaveResultTool
from .show_result import ShowResultTool, conf_to_hist, hist_to_vis

__all__ = ["disp_map", "disp_to_color", "disp_err_to_color", "group_color",
           "SaveResultTool", "ShowResultTool", "conf_to_hist", "hist_to_vis"]
