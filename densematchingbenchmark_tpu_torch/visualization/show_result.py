"""Result-dict visualization: disparity, error and confidence panels.

Counterpart of densematchingbenchmark_tpu/visualization/show_result.py
(numpy): a model's result dict becomes display-ready images, colour
disparity maps per estimate, error maps against the GT, the 2x2 group
panel, and confidence maps with their histograms (``conf_to_hist``,
``hist_to_vis``).
"""

import numpy as np

from .colormap import disp_err_to_color, disp_to_color, group_color


def _squeeze(x):
    x = np.asarray(x)
    while x.ndim > 2:
        x = x[0] if x.shape[0] == 1 else x[..., 0]
    return x


def conf_to_hist(conf, bins=100):
    """Confidence map -> normalized histogram over [0, 1]."""
    conf = _squeeze(conf)
    hist, _ = np.histogram(np.clip(conf, 0, 1), bins=bins, range=(0, 1))
    return hist / max(hist.sum(), 1)


def hist_to_vis(hist, height=200):
    """Histogram -> a bar image [height, bins, 3] (0-255)."""
    bins = len(hist)
    img = np.full((height, bins, 3), 255, np.float32)
    peak = max(hist.max(), 1e-9)
    for i, v in enumerate(hist):
        h = int(round(v / peak * (height - 1)))
        if h > 0:
            img[height - h:, i] = (70, 130, 180)
    return img


class ShowResultTool:
    """result dict -> dict of display images.

    Input keys: 'disps' (list, best first), optional 'confs' (list),
    'leftDisp' (GT), 'leftImage'. Output: {'disp_0': colour,
    'disp_0_err': ..., 'group': panel, 'conf_0': grey 0-255,
    'conf_0_hist': bar image, ...}.
    """

    def __init__(self, max_disp=192):
        self.max_disp = max_disp

    def __call__(self, result):
        out = {}
        gt = result.get("leftDisp")
        gt2 = _squeeze(gt) if gt is not None else None
        left = result.get("leftImage")
        for i, disp in enumerate(result.get("disps", [])):
            d = _squeeze(disp)
            out[f"disp_{i}"] = disp_to_color(d, self.max_disp)
            if gt2 is not None:
                out[f"disp_{i}_err"] = disp_err_to_color(d, gt2)
        if result.get("disps"):
            li = None
            if left is not None:
                li = np.asarray(left)
                if li.ndim == 4:
                    li = li[0]
            out["group"] = group_color(_squeeze(result["disps"][0]), gt2, li)
        for i, conf in enumerate(result.get("confs", [])):
            c = np.clip(_squeeze(conf), 0, 1)
            out[f"conf_{i}"] = (c * 255.0).astype(np.float32)
            out[f"conf_{i}_hist"] = hist_to_vis(conf_to_hist(c))
        return out
