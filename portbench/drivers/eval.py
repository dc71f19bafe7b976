"""Scoring a model on a stereo data set, as ``tools/test`` does:
``evaluation.evaluate(module, dataset, eval_cfg, eval_disparity_ids,
step=<prebuilt>)`` called again and again in a closed loop, each call one
pass over the data set.

The samples come from the port's file data set (``data.build_dataset``
on the configuration's data section, a JSON annotation in KITTI 2015's
layout) reading PNG images and uint16 disparity PNGs that set-up writes
from the seed under the run's scratch directory, each row filtered as
the traffic's ``png_filters`` mix draws it; every sample is decoded,
padded and normalized by the port's loader threads in the window.

A pass holds ``samples`` samples (KITTI 2015's 200 training pairs, which
``tools/test`` scores in one pass), sample ``i`` showing scene ``i %
pairs``: set-up makes ``pairs`` distinct scenes, and the loader decodes
every sample anew all the same.

What the timed path produced is kept for the check: the three disparity
maps and the metric step's EPE of the frames of two batches, one drawn
from the seed in the first pass, one at a drawn position of the window's
last pass.
"""

import json
import os
import time

import numpy as np
import torch

from .. import pngfile


class Subset:
    def __init__(self, dataset, n):
        self.dataset, self.n = dataset, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.dataset[i]


class TimedLoads:
    """The data set with each sample's load timed into the tracer's
    ``sample_load`` span."""

    def __init__(self, dataset, tracer):
        self.dataset, self.tracer = dataset, tracer

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        t = time.perf_counter()
        s = self.dataset[i]
        self.tracer.span("sample_load", time.perf_counter() - t)
        return s


class Capture:
    """Keeps the disparities and metrics of the wanted batches: batch
    ``first`` of pass 0 and batch ``last`` of the latest pass."""

    def __init__(self, module, real_step, first, last, tracer):
        self.real_step, self.tracer = real_step, tracer
        self.first, self.last = first, last
        self.armed = False
        self.pass_index = self.batch = 0
        self.grab = False
        self.grabbed = None
        self.kept = {}
        module.register_forward_hook(self._hook)

    def _hook(self, _module, _args, out):
        if self.grab:
            # the output itself: read once the step is done, after every
            # hook has run
            self.grabbed = out

    def new_pass(self, index):
        self.pass_index, self.batch = index, 0

    def step(self, batch):
        j = self.batch
        self.batch += 1
        want = self.armed and ((self.pass_index == 0 and j == self.first)
                               or j == self.last)
        self.grab = want
        result = self.real_step(batch)
        self.grab = False
        if self.armed:
            self.tracer.tick(int(batch["leftImage"].shape[0]), False)
        if want:
            kept = (self.pass_index, j, list(self.grabbed["disps"]), result)
            if self.pass_index == 0 and j == self.first:
                self.kept["first"] = kept
            if j == self.last:
                self.kept["last"] = kept
        return result


def _write_files(ctx, root):
    """Writes each scene's left and right PNGs and its disparity PNG in
    KITTI 2015's layout under ``root``; returns (scenes, annotation
    path)."""
    t = ctx.traffic
    mix, level = t["png_filters"], t.get("png_level", 6)
    dirs = {k: os.path.join(root, "training", k)
            for k in ("image_2", "image_3", "disp_occ_0")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    def write(i, s):
        name = f"{i:06d}_10.png"
        gt16 = np.clip(np.rint(s["disp"] * 256.0), 0, 65535).astype(
            np.uint16)
        for n, (k, img) in enumerate((("image_2", s["left"]),
                                      ("image_3", s["right"]),
                                      ("disp_occ_0", gt16))):
            rng = ctx.rng(1, i, n)
            data = pngfile.encode(img, pngfile.row_filters(
                mix, img.shape[0], rng), level)
            with open(os.path.join(dirs[k], name), "wb") as fp:
                fp.write(data)

    scenes = ctx.scenes(t["pairs"], each=write)
    h, w = t["frame"]
    ann = [{"left_image_path": f"training/image_2/{i:06d}_10.png",
            "right_image_path": f"training/image_3/{i:06d}_10.png",
            "left_disp_map_path": f"training/disp_occ_0/{i:06d}_10.png",
            "height": h, "width": w}
           for i in (k % t["pairs"] for k in range(t["samples"]))]
    path = os.path.join(root, "kitti15_test.json")
    with open(path, "w") as fp:
        json.dump(ann, fp)
    return scenes, path


def prepare(ctx):
    from densematchingbenchmark_tpu_torch.data import (build_dataset,
                                                       transforms)
    from densematchingbenchmark_tpu_torch.evaluation.eval_loop import (
        evaluate, make_eval_metrics_step)
    t = ctx.traffic
    model, weights = ctx.init_model()
    ctx.mark("model")
    cfg, module = model.cfg, model.module
    pad = tuple(t["pad_to"])
    data = cfg["data"]
    transform = transforms.make_eval_transform(pad, data["mean"],
                                               data["std"])
    root = os.path.join(ctx.tmpdir, "kitti")
    scenes, ann = _write_files(ctx, root)
    data["data_root"] = root
    data["test"].update(annfile=ann, input_shape=pad)
    dataset = build_dataset(data, "test", transform=transform)
    ctx.mark("data")
    if ctx.tracer.enabled:
        dataset = TimedLoads(dataset, ctx.tracer)
    eval_cfg = dict(cfg["model"].get("eval", {}), batch_size=t["batch"])
    ids = tuple(t["eval_disparity_ids"])
    real_step = make_eval_metrics_step(
        module, eval_cfg.get("lower_bound", 0),
        eval_cfg.get("upper_bound", 192), ids,
        eval_cfg.get("eval_occlusion", False),
        eval_cfg.get("occ_compat_warp", False))
    batches = t["samples"] // t["batch"]
    first, last = (int(v) for v in ctx.rng(2).integers(0, batches, 2))
    capture = Capture(module, real_step, first, last, ctx.tracer)
    ctx.tracer.attach(module)
    state = {"ctx": ctx, "module": module, "weights": weights,
             "dataset": dataset, "eval_cfg": eval_cfg, "ids": ids,
             "capture": capture, "scenes": scenes, "cfg": cfg,
             "evaluate": evaluate}
    # warm-up: the window's shapes, outside the window
    evaluate(module, Subset(dataset, t.get("warmup_pairs", 2 * t["batch"])),
             eval_cfg, ids, step=capture.step)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    ctx.mark("warm-up")
    capture.armed = True
    return state


def window(state, seconds, tracer):
    evaluate, module = state["evaluate"], state["module"]
    capture = state["capture"]
    frames = calls = 0
    tracer.begin()
    t0 = time.perf_counter()
    while True:
        capture.new_pass(calls)
        _, n = evaluate(module, state["dataset"], state["eval_cfg"],
                        state["ids"], step=capture.step)
        frames += n
        calls += 1
        tracer.tick(0, True)
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    return {"frames": frames, "calls": calls, "elapsed_s": elapsed,
            "attempted": frames, "failed": 0}


def outputs(state):
    """[{'disps': [three [H, W] maps], 'epe': [three floats], 'left',
    'right', 'gt': the scene's raw arrays}] of the kept frames; frees
    the program's state."""
    ctx = state["ctx"]
    b = ctx.traffic["batch"]
    frames = []
    for key in ("first", "last"):
        if key not in state["capture"].kept:
            continue
        _, j, disps, metrics = state["capture"].kept[key]
        for i in range(disps[0].shape[0]):
            s = state["scenes"][(j * b + i) % len(state["scenes"])]
            frames.append({
                "disps": [d[i, ..., 0].float() for d in disps],
                "epe": [float(metrics[did]["epe"][i])
                        for did in state["ids"]],
                "left": s["left"], "right": s["right"], "gt": s["disp"]})
    for k in ("module", "dataset", "capture", "evaluate"):
        state.pop(k, None)
    return frames
