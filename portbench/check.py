"""The correctness check: what the timed path produced against the plain
reference, run once the window has closed and the program's state is
freed, one frame at a time.

The reference takes the scene's raw uint8 images and pads and normalizes
them itself (zeros above and right of the frame, then (x - mean) / std,
as the configurations' eval transform does), in float32 with TF32 off.
Each kept frame's three disparity maps are compared over the whole
padded frame (``view`` 'padded': the eval loop's outputs) or the frame
cropped back to its size (``view`` 'crop': what ``inference_stereo``
returns). The number each cell's limit holds (limits/<workload>.json) is
``disp_gap_bf16x``: the program's mean absolute gap to the float32
reference over the kept maps, in units of the same gap of the reference
with its convolution operands rounded to bfloat16 (the configurations'
precision) on the same frames. At random weights the soft-argmin's
sensitivity to its costs changes several-fold from seed to seed; the
ratio takes that out, where the gap in pixels swings with it (PERF.md
gives the readings of every number below).

The control (``control``) puts the reference computed in a lower
precision (float8 operands) in the program's place.
"""

import math

import numpy as np
import torch

from .reference import metrics, stereo
from .reference.precision import identity, rounding


def _prepare(img, pad_to, mean, std, device):
    th, tw = pad_to
    h, w = img.shape[:2]
    x = np.zeros((th, tw, 3), np.float32)
    x[th - h:, :w] = img
    x = (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return torch.from_numpy(x).permute(2, 0, 1)[None].to(device)


def reference_maps(ref, frame, pad_to, mean, std, device, rounding):
    """The reference's three [Hp, Wp] maps of ``frame``."""
    with torch.no_grad():
        out = ref(_prepare(frame["left"], pad_to, mean, std, device),
                  _prepare(frame["right"], pad_to, mean, std, device),
                  rounding)
    return [d[0] for d in out]


def _crop(maps, size, pad_to):
    h, w = size
    return [m[pad_to[0] - h:, :w] for m in maps]


def _finite(v):
    """A NaN or infinite reading fails every limit."""
    return v if math.isfinite(v) else math.inf


def compare(frames, weights, config, pad_to, mean, std, view, device,
            control=None):
    """The numbers of ``frames`` (drivers' ``outputs``): the program's
    maps against the float32 reference's or, with ``control`` (a
    precision of reference/precision.py), the reference computed in that
    precision in the program's place. Beside them on the same frames, the
    reference with bfloat16 convolution operands: the gap that bfloat16
    rounding alone gives, the yardstick of the ``*_bf16x`` numbers.

    Per map (a frame's output): the mean absolute gap in px and the share
    of pixels more than 3 px apart; per map with ground truth, the gap
    between the two EPEs. Numbers: ``disp_gap_px`` (the largest map
    gap), ``disp_gap_mean_px`` and ``disp_bad3_pct`` (means over the
    maps), ``epe_gap_px`` / ``epe_gap_mean_px`` (largest and mean EPE
    gap), and ``disp_gap_bf16x``, ``disp_bad3_bf16x``, ``epe_gap_bf16x``:
    the mean ones over the yardstick's."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = stereo.build(config["family"], config["model"]["max_disp"],
                           weights, device)
        ub = config["model"]["max_disp"]
        acc = {side: {"gap": [], "bad3": [], "epe": []}
               for side in ("program", "bf16")}
        for f in frames:
            size = f["left"].shape[:2]
            maps = {"ref": reference_maps(ref, f, pad_to, mean, std, device,
                                          identity),
                    "bf16": reference_maps(ref, f, pad_to, mean, std,
                                           device, rounding("bf16"))}
            maps["program"] = (
                [d.to(device) for d in f["disps"]] if control is None else
                reference_maps(ref, f, pad_to, mean, std, device,
                               rounding(control)))
            if view == "crop":
                maps = {k: _crop(v, size, pad_to) if k != "program" or
                        control is not None else v for k, v in maps.items()}
            gt = None
            if "gt" in f:
                gt = np.zeros(tuple(pad_to), np.float32)
                gt[pad_to[0] - size[0]:, :size[1]] = f["gt"]
                gt = metrics.as_tensor(gt, device)
            for k, r in enumerate(maps["ref"]):
                e_ref = None if gt is None else metrics.epe(r, gt, 0.0, ub)
                for side in ("program", "bf16"):
                    m = maps[side][k]
                    diff = (m.float() - r).abs()
                    acc[side]["gap"].append(float(diff.mean()))
                    acc[side]["bad3"].append(
                        float((diff > 3.0).float().mean()) * 100.0)
                    if gt is not None:
                        e = (f["epe"][k] if side == "program" and control
                             is None else metrics.epe(m, gt, 0.0, ub))
                        acc[side]["epe"].append(abs(e - e_ref))
        prog, yard = acc["program"], acc["bf16"]

        def avg(v):
            return sum(v) / len(v) if v else math.nan

        def ratio(a, b):
            return avg(a) / avg(b) if avg(b) > 0 else math.inf

        out = {}
        if prog["gap"]:
            out.update(disp_gap_px=max(prog["gap"]),
                       disp_gap_mean_px=avg(prog["gap"]),
                       disp_bad3_pct=avg(prog["bad3"]),
                       disp_gap_bf16x=ratio(prog["gap"], yard["gap"]))
        if prog["epe"]:
            out.update(epe_gap_px=max(prog["epe"]),
                       epe_gap_mean_px=avg(prog["epe"]),
                       epe_gap_bf16x=ratio(prog["epe"], yard["epe"]))
        return {k: _finite(v) for k, v in out.items()}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
