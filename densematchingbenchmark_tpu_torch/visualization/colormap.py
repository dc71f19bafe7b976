"""Disparity visualization: the KITTI colour ramp and error maps.

This package's own copy of
densematchingbenchmark_tpu/visualization/colormap.py:1-74 (numpy), writing
its panel through the port's PNG encoder.
"""

import numpy as np

from ..data.io import save_png

# KITTI devkit color histogram: 7 bins, RGB anchors + bin widths
_ANCHORS = np.array([
    [0, 0, 0], [0, 0, 1], [1, 0, 0], [1, 0, 1],
    [0, 1, 0], [0, 1, 1], [1, 1, 0], [1, 1, 1]], np.float64)
_WIDTHS = np.array([114., 185., 114., 174., 114., 185., 114.])

# KITTI error-map log-scale bins and colors (disp_err_to_color parity)
_ERR_COLS = np.array([
    [0.1875, 0.0, 49, 54, 149],
    [0.375, 0.1875, 69, 117, 180],
    [0.75, 0.375, 116, 173, 209],
    [1.5, 0.75, 171, 217, 233],
    [3.0, 1.5, 224, 243, 248],
    [6.0, 3.0, 254, 224, 144],
    [12.0, 6.0, 253, 174, 97],
    [24.0, 12.0, 244, 109, 67],
    [48.0, 24.0, 215, 48, 39],
    [float("inf"), 48.0, 165, 0, 38]])


def disp_map(norm_disp):
    """[N] values in [0, 1] -> [N, 3] RGB in [0, 1] via the 7-bin ramp."""
    x = np.asarray(norm_disp, np.float64).ravel()
    cum = np.cumsum(_WIDTHS) / _WIDTHS.sum()          # bin upper edges
    lo = np.concatenate([[0.0], cum[:-1]])            # bin lower edges
    s = np.searchsorted(cum[:-1], x, side="right")    # bin index 0..6
    frac = (x - lo[s]) / (_WIDTHS[s] / _WIDTHS.sum())
    frac = np.clip(frac, 0.0, 1.0)[:, None]
    return _ANCHORS[s] * (1 - frac) + _ANCHORS[s + 1] * frac


def disp_to_color(disp, max_disp=None):
    """[H, W] disparity -> [H, W, 3] RGB uint8-range float, KITTI ramp."""
    disp = np.asarray(disp, np.float64)
    scale = float(max_disp) if max_disp is not None else max(disp.max(), 1e-6)
    rgb = disp_map(np.clip(disp / scale, 0, 1))
    return (rgb.reshape(disp.shape + (3,)) * 255.0).astype(np.float32)


def disp_err_to_color(est, gt):
    """KITTI error visualization: log-binned |est-gt| color map [H, W, 3]."""
    err = np.abs(np.asarray(est, np.float64) - np.asarray(gt, np.float64))
    out = np.zeros(err.shape + (3,), np.float32)
    for hi, lo, r, g, b in _ERR_COLS:
        m = (err >= lo) & (err < hi)
        out[m] = (r, g, b)
    out[np.asarray(gt) <= 0] = 0  # invalid GT stays black
    return out


def group_color(est, gt=None, left=None, save_path=None):
    """2x2 panel: [est | gt ; error | left] like the reference GroupColor."""
    h, w = est.shape
    md = gt.max() if gt is not None else None
    panel = np.zeros((2 * h, 2 * w, 3), np.float32)
    panel[:h, :w] = disp_to_color(est, md)
    if gt is not None:
        panel[:h, w:] = disp_to_color(gt, md)
        panel[h:, :w] = disp_err_to_color(est, gt)
    if left is not None:
        panel[h:, w:] = left[..., :3]
    if save_path is not None:
        save_png(save_path, np.clip(panel, 0, 255).astype(np.uint8))
    return panel
