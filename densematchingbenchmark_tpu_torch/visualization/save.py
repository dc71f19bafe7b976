"""Result saving: KITTI submission PNGs and colour visualizations.

Counterpart of densematchingbenchmark_tpu/visualization/save.py:18-51,
writing through the port's PNG encoder:
  disp_0/<name>.png       uint16 x256 (KITTI submission format)
  color_disp/<name>.png   KITTI colour ramp
  group_disp/<name>.png   2x2 panel (estimate, GT, error, left image)
"""

import os
import os.path as osp

import numpy as np

from ..data.io import save_kitti_disp, save_png
from .colormap import disp_to_color, group_color


def _hw(x):
    """[1, H, W, 1], [H, W, 1] or [H, W] -> [H, W]."""
    x = np.asarray(x)
    if x.ndim == 4:
        return x[0, ..., 0]
    return x[..., 0] if x.ndim == 3 else x


class SaveResultTool:
    def __init__(self, out_dir):
        self.out_dir = out_dir

    def _dir(self, sub):
        path = osp.join(self.out_dir, sub)
        os.makedirs(path, exist_ok=True)
        return path

    def __call__(self, name, est_disp, gt_disp=None, left_image=None):
        est_disp = _hw(est_disp)
        save_kitti_disp(osp.join(self._dir("disp_0"), f"{name}.png"),
                        est_disp)
        save_png(osp.join(self._dir("color_disp"), f"{name}.png"),
                 np.clip(disp_to_color(est_disp), 0, 255).astype(np.uint8))
        if gt_disp is not None or left_image is not None:
            gt = _hw(gt_disp) if gt_disp is not None else None
            left = np.asarray(left_image) if left_image is not None else None
            if left is not None and left.ndim == 4:
                left = left[0]
            group_color(est_disp, gt, left,
                        save_path=osp.join(self._dir("group_disp"),
                                           f"{name}.png"))
