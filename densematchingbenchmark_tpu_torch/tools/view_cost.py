"""Cost-volume inspector: per-pixel cost distributions as PNG plots.

    python -m densematchingbenchmark_tpu_torch.tools.view_cost \\
        --config PSMNet/scene_flow --out-dir costs/ [--work-dir DIR] \\
        [--pixels 120,340 ...] [--num-random 4] [--override k=v ...] [--cpu]

Counterpart of the repository's tools/view_cost.py:18-123. The model
(random weights of seed 0, or the latest checkpoint under
``<work-dir>/checkpoints/``) runs on the 256x512 synthetic pair
(SyntheticStereoDataset, max_disp min(model.max_disp, 64), normalized by
the config's mean and std); for each pixel (``--pixels`` y,x pairs, else
``--num-random`` drawn by RandomState(0) from the middle half of each
axis) the softmax over disparity of its cost, the estimate and the GT
(``cost_curves``). Each is drawn without a plotting library into an
RGB array (``draw_curve``: the curve in blue, the estimate as an orange
dashed line, the GT as a green dotted one) and written with data/io.save_png as
``<out-dir>/cost_y{y}_x{x}.png``. The pixels index the first cost volume
as the model returns it: in the fused eval mode
(``model.eval.fused_upsample_argmin``) that is the low-resolution volume
and a full-resolution pixel raises IndexError, as the JAX tool does; a
model that returns no cost volume (DeepPruner) raises AssertionError.
Runs on the GPU; ``--cpu`` on the CPU; without either it raises.
"""

import argparse
import os

import numpy as np
import torch

from ..apis import init_model
from ..data import SyntheticStereoDataset, io, transforms
from .common import add_cpu_arg, parse_overrides, tool_device

PLOT_SIZE = (352, 770)     # rows, columns: JAX's 7 x 3.2 in at 110 dpi
MARGINS = (20, 20, 40, 50)   # top, right, bottom, left
CURVE = (31, 119, 180)
EST = (255, 127, 14)
GT = (44, 160, 44)


def synthetic_pair(cfg):
    """(the raw 256x512 synthetic sample, the normalized one)."""
    ds = SyntheticStereoDataset(length=1, height=256, width=512,
                                max_disp=min(cfg["model"]["max_disp"], 64))
    sample = ds[0]
    return sample, transforms.normalize(sample, cfg["data"]["mean"],
                                        cfg["data"]["std"])


def cost_curves(model, pixels=None, num_random=4):
    """The curves of ``model`` (an apis.StereoModel) on the synthetic
    pair: {'d_axis': [D], 'curves': [{'y', 'x', 'prob' [D] (softmax of
    the pixel's cost over D), 'est', 'gt'}]} (numpy, float32)."""
    sample, norm = synthetic_pair(model.cfg)
    left, right = (torch.from_numpy(norm[k])[None].to(model.device)
                   for k in ("leftImage", "rightImage"))
    out = model.forward(left, right)
    if not out.get("costs"):
        raise AssertionError("model returned no cost volumes to inspect")
    cost = out["costs"][0][0].float().cpu().numpy()        # [D, H, W]
    disp = out["disps"][0][0, ..., 0].float().cpu().numpy()
    gt = sample.get("leftDisp")
    h, w = disp.shape
    if pixels is None:
        rng = np.random.RandomState(0)
        pixels = [(int(rng.randint(h // 4, 3 * h // 4)),
                   int(rng.randint(w // 4, 3 * w // 4)))
                  for _ in range(num_random)]
    curves = []
    for y, x in pixels:
        c = cost[:, y, x]
        prob = np.exp(c - c.max())
        prob /= prob.sum()
        curves.append({"y": y, "x": x, "prob": prob,
                       "est": float(disp[y, x]),
                       "gt": None if gt is None else float(gt[y, x, 0])})
    return {"d_axis": np.arange(cost.shape[0]), "curves": curves}


def draw_curve(prob, est=None, gt=None):
    """uint8 [PLOT_SIZE, 3]: ``prob`` over disparities 0..D-1 as a line in
    a framed plot (y from 0 to 1.05 max, a tick every D / 8 disparities),
    the estimate and the GT as vertical lines where they fall inside
    it."""
    size = PLOT_SIZE
    img = np.full(size + (3,), 255, np.uint8)
    top_margin, right, bottom, left = MARGINS
    y0, y1, x0, x1 = top_margin, size[0] - bottom, left, size[1] - right
    n = len(prob)

    def col(d):
        return x0 + d * (x1 - x0) / max(n - 1, 1)

    top = max(float(np.max(prob)) * 1.05, 1e-12)
    rows = y1 - (np.asarray(prob, np.float64) / top) * (y1 - y0)
    cols = col(np.arange(n))
    for i in range(n - 1):   # the polyline, two pixels thick
        k = int(max(abs(cols[i + 1] - cols[i]),
                    abs(rows[i + 1] - rows[i]))) + 2
        t = np.linspace(0.0, 1.0, k)
        r = np.rint(rows[i] + t * (rows[i + 1] - rows[i])).astype(int)
        c = np.rint(cols[i] + t * (cols[i + 1] - cols[i])).astype(int)
        for dr in (0, 1):
            img[np.clip(r + dr, y0, y1), c] = CURVE
    for d in range(0, n, max(1, int(round(n / 8)))):
        img[y1:y1 + 6, int(round(col(d)))] = 0
    for value, color, period in ((est, EST, 12), (gt, GT, 4)):
        if value is None or not 0 <= value <= n - 1:
            continue
        r = np.arange(y0, y1 + 1)
        img[r[(r - y0) % period < period // 2], int(round(col(value)))] = \
            color
    img[y0, x0:x1 + 1] = img[y1, x0:x1 + 1] = 0   # the frame
    img[y0:y1 + 1, x0] = img[y0:y1 + 1, x1] = 0
    return img


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Inspect cost distributions")
    p.add_argument("--config", required=True)
    p.add_argument("--work-dir", default=None, help="checkpoint dir")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--pixels", nargs="*", default=None,
                   help="pixels to inspect as y,x pairs, e.g. 120,340")
    p.add_argument("--num-random", type=int, default=4)
    p.add_argument("--override", nargs="*", default=[])
    add_cpu_arg(p)
    return p.parse_args(argv)


def main(argv=None):
    """Writes one PNG a pixel; returns the curves (``cost_curves``)."""
    args = parse_args(argv)
    device = tool_device(args)
    model = init_model(args.config, device=device,
                       checkpoint_dir=args.work_dir,
                       **parse_overrides(args.override))
    pixels = ([tuple(map(int, p.split(","))) for p in args.pixels]
              if args.pixels else None)
    result = cost_curves(model, pixels, args.num_random)
    os.makedirs(args.out_dir, exist_ok=True)
    for c in result["curves"]:
        path = os.path.join(args.out_dir, f"cost_y{c['y']}_x{c['x']}.png")
        io.save_png(path, draw_curve(c["prob"], c["est"], c["gt"]))
        print(f"wrote {path}")
    return result


if __name__ == "__main__":
    main()
