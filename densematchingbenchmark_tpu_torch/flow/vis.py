"""Optical-flow visualisation: the Middlebury colour wheel.

Counterpart of densematchingbenchmark_tpu/flow/vis.py, kept as this
package's own copy (hue the direction, saturation the magnitude, 55
bins), with ``SaveFlowResultTool`` writing its PNGs through the port's
own encoder (data/io.save_png).
"""

import os
import os.path as osp

import numpy as np

from ..data.io import save_png
from .io import save_flo


def _make_color_wheel():
    """[55, 3] RGB colour wheel (RY/YG/GC/CB/BM/MR segments)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((ry + yg + gc + cb + bm + mr, 3))
    col = 0
    wheel[:ry, 0] = 255
    wheel[:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col:col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col:col + yg, 1] = 255
    col += yg
    wheel[col:col + gc, 1] = 255
    wheel[col:col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col:col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col:col + cb, 2] = 255
    col += cb
    wheel[col:col + bm, 2] = 255
    wheel[col:col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col:col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col:col + mr, 0] = 255
    return wheel


_WHEEL = _make_color_wheel()


def flow_to_color(flow, max_flow=None):
    """[H, W, 2] flow -> [H, W, 3] float32 RGB in 0-255; NaN pixels
    black."""
    u, v = flow[..., 0].astype(np.float64), flow[..., 1].astype(np.float64)
    nan = np.isnan(u) | np.isnan(v)
    u, v = np.nan_to_num(u), np.nan_to_num(v)
    rad = np.sqrt(u * u + v * v)
    scale = max_flow if max_flow is not None else max(rad.max(), 1e-6)
    u, v, rad = u / scale, v / scale, np.minimum(rad / scale, 1.0)

    n = len(_WHEEL)
    angle = np.arctan2(-v, -u) / np.pi          # [-1, 1]
    fk = (angle + 1.0) / 2.0 * (n - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % n
    f = (fk - k0)[..., None]
    col = _WHEEL[k0] * (1 - f) + _WHEEL[k1] * f  # [H, W, 3] in [0, 255]
    col = col / 255.0
    col = 1.0 - rad[..., None] * (1.0 - col)    # saturate with magnitude
    col[nan] = 0.0
    return (col * 255.0).astype(np.float32)


class SaveFlowResultTool:
    """Per sample, the estimated flow as <out_dir>/flow_0/<name>.flo and
    its colour wheel as <out_dir>/color_flow/<name>.png."""

    def __init__(self, out_dir):
        self.out_dir = out_dir

    def __call__(self, name, est_flow):
        est_flow = np.asarray(est_flow, np.float32)
        if est_flow.ndim == 4:
            est_flow = est_flow[0]
        flo_dir = osp.join(self.out_dir, "flow_0")
        os.makedirs(flo_dir, exist_ok=True)
        save_flo(osp.join(flo_dir, f"{name}.flo"), est_flow)
        color_dir = osp.join(self.out_dir, "color_flow")
        os.makedirs(color_dir, exist_ok=True)
        save_png(osp.join(color_dir, f"{name}.png"),
                 np.clip(flow_to_color(est_flow), 0, 255).astype(np.uint8))
