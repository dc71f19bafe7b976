"""Evaluate a stereo model over a test set; optionally save the results.

    python -m densematchingbenchmark_tpu_torch.tools.test \\
        --config PSMNet/kitti_2015_f32 --work-dir work/psmnet \\
        --data-root /data/KITTI-2015 --annfile /data/kitti15_val.json \\
        [--out-dir results] [--override data.test.use_right_disp=True] [--cpu]
        [--dtype bfloat16]

The counterpart of the JAX package's tools/test.py for stereo models:
the test split's file dataset (or ``--synthetic``) through the eval
transform, the model restored from <work-dir>/checkpoints/ (seeded random
weights, with a warning, when there is none), the batched evaluation on the
device, and the metric table. ``--out-dir`` writes, per sample, the KITTI
submission PNG, the colour map and the 2x2 panel, cropped to the sample's
original size. With a confidence network (AcfNet adaptive) a batch-1
pass over the samples with GT measures the sparsification curves
(evaluation/sparsification.py) and prints their average over the set as
est / oracle / random rows; with ``--out-dir`` it also writes each
sample's confidence map and histogram to confidence/. ``--dtype bfloat16``
(or a ``_bf16`` config name) evaluates in bfloat16 compute; the metrics
stay float32. Runs on the GPU unless ``--cpu``; with neither it raises.
A flow config (PWCFlow, RAFT) scores the best flow of each sample of a
FlyingChairs annotation (padded to data.pad_to_size) or of four synthetic
pairs at data.crop_size (``--synthetic``) by EPE and n-px, and with
``--out-dir`` writes each sample's .flo and colour wheel. Multi-process
launchers (ROADMAP.md queue 1 item 5) are not ported and raise.
"""

import argparse
import os

import numpy as np

from ..apis import init_model
from ..configs import get_config
from ..data import SyntheticStereoDataset, build_dataset, collate, transforms
from ..data.io import save_png
from ..evaluation.eval_loop import evaluate, to_device
from ..evaluation.format import metrics_table
from ..evaluation.metrics import remove_padding
from ..evaluation.sparsification import sparsification_plot
from ..utils.checkpoint import CheckpointManager
from ..visualization import SaveResultTool, conf_to_hist, hist_to_vis
from .common import (add_distributed_args, add_dtype_arg, check_launcher,
                     config_overrides)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a dense matching model")
    p.add_argument("--config", required=True,
                   help="config name, e.g. PSMNet/kitti_2015_f32 or "
                        "PSMNet/kitti_2015_bf16")
    p.add_argument("--work-dir", required=True,
                   help="dir containing checkpoints/ (from train.py)")
    p.add_argument("--data-root", default=None)
    p.add_argument("--annfile", default=None)
    p.add_argument("--out-dir", default=None,
                   help="save disp_0/ (KITTI submission) + colour maps here")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch versions on the CPU")
    p.add_argument("--override", nargs="*", default=[])
    add_dtype_arg(p)
    add_distributed_args(p)
    return p.parse_args(argv)


def save_results(model, ds, out_dir, mean, std, eval_cfg=None):
    """Batch-1 forward of every sample; with ``out_dir``, its best
    disparity, GT and left image at the sample's original size through
    SaveResultTool. With confidence outputs and GT, the sparsification
    curves of each sample (bounds from ``eval_cfg``) and, with
    ``out_dir``, its confidence map and histogram as PNGs. Returns
    ({'est_P' | 'oracle_P' | 'random_P': EPE averaged over those
    samples}, samples)."""
    save = SaveResultTool(out_dir) if out_dir else None
    eval_cfg = eval_cfg or {}
    sums, count = {}, 0
    for i in range(len(ds)):
        batch = collate([ds[i]])
        h, w = batch["original_size"]
        x = to_device({k: batch[k] for k in ("leftImage", "rightImage")},
                      model.device)
        out = model.forward(x["leftImage"], x["rightImage"])
        disp = out["disps"][0].float().cpu().numpy()
        gt = batch.get("leftDisp")
        if save is not None:
            left = batch["leftImage"] * np.asarray(std, np.float32) + \
                np.asarray(mean, np.float32)
            save(f"{i:06d}", remove_padding(disp, h, w),
                 None if gt is None else remove_padding(gt, h, w),
                 remove_padding(left, h, w))
        if "confs" not in out or gt is None:
            continue
        # on the padded frame, as the JAX tool (the padding's GT is 0,
        # outside the bounds)
        conf = out["confs"][0].float().cpu().numpy()
        curves = sparsification_plot(
            disp, gt, conf, lb=eval_cfg.get("lower_bound", 0),
            ub=eval_cfg.get("upper_bound", 192), seed=i)
        for k, v in curves.items():
            sums[k] = sums.get(k, 0.0) + v
        count += 1
        if save is not None:
            conf_dir = os.path.join(out_dir, "confidence")
            os.makedirs(conf_dir, exist_ok=True)
            c = np.clip(remove_padding(conf, h, w)[0, ..., 0], 0, 1)
            save_png(os.path.join(conf_dir, f"{i:06d}.png"),
                     (c * 255).astype(np.uint8))
            save_png(os.path.join(conf_dir, f"{i:06d}_hist.png"),
                     np.clip(hist_to_vis(conf_to_hist(c)), 0,
                             255).astype(np.uint8))
    return {k: v / max(count, 1) for k, v in sums.items()}, count


def sparsification_rows(curves, count):
    """The est / oracle / random rows of averaged sparsification curves."""
    lines = [f"sparsification ({count} samples, EPE after removing "
             f"least-confident X%):"]
    pcts = sorted({int(k.split("_")[-1]) for k in curves})
    for series in ("est", "oracle", "random"):
        row = " ".join(f"{curves[f'{series}_{p}']:7.3f}" for p in pcts)
        lines.append(f"  {series:7s} {row}")
    return "\n".join(lines)


def flow_main(args, cfg):
    """The flow branch (the JAX tools/test.py:33-91): returns ({'epe',
    '1px', '2px', '3px', '5px': mean}, samples)."""
    from ..apis import init_flow_model
    from ..flow import transforms as ftrans
    from ..flow.datasets import FlyingChairsDataset, SyntheticFlowDataset
    from ..flow.trainer import evaluate_flow
    from ..flow.vis import SaveFlowResultTool

    mean, std = cfg["data"]["mean"], cfg["data"]["std"]
    crop = tuple(cfg["data"].get("crop_size", (320, 448)))
    pad = tuple(cfg["data"].get("pad_to_size", (384, 512)))
    if args.synthetic:
        ds = SyntheticFlowDataset(
            length=4, height=crop[0], width=crop[1],
            transform=ftrans.make_eval_transform(crop, mean, std))
    else:
        cfg["data"]["data_root"] = args.data_root
        ds = FlyingChairsDataset(
            args.annfile, args.data_root,
            transform=ftrans.make_eval_transform(pad, mean, std))
    if CheckpointManager(args.work_dir).latest_step() is None:
        print("WARNING: no checkpoint found, evaluating random init")
    model = init_flow_model(cfg, device="cpu" if args.cpu else None,
                            checkpoint_dir=args.work_dir)
    results, n = evaluate_flow(
        model.module, ds,
        sparse=cfg["model"].get("eval", {}).get("sparse", False))
    print(f"evaluated {n} samples:")
    for k in sorted(results):
        print(f"  {k:12s} {results[k]:.4f}")
    if args.out_dir:
        save = SaveFlowResultTool(args.out_dir)
        for i in range(len(ds)):
            batch = collate([ds[i]])
            x = to_device({k: batch[k] for k in ("leftImage",
                                                 "rightImage")},
                          model.device)
            out = model.forward(x["leftImage"], x["rightImage"])
            save(f"{i:06d}", out["flows"][0].float().cpu().numpy())
        print(f"results saved to {args.out_dir}")
    return results, n


def main(argv=None):
    """Returns ({f'disp_{id}/{metric}': mean, plus with a cmn
    f'sparsification/{series}_{P}'}, samples); for a flow config
    ``flow_main``'s."""
    args = parse_args(argv)
    check_launcher(args)
    cfg = get_config(args.config, **config_overrides(args))
    if cfg.get("task") == "flow":
        return flow_main(args, cfg)
    mean, std = cfg["data"]["mean"], cfg["data"]["std"]
    if args.synthetic:
        maxd = cfg["model"]["max_disp"]
        ds = SyntheticStereoDataset(length=4, height=256, width=512,
                                    max_disp=min(maxd, 64))
        ds.transform = transforms.make_eval_transform((256, 512), mean, std)
    else:
        cfg["data"]["data_root"] = args.data_root
        cfg["data"]["test"]["annfile"] = args.annfile
        ds = build_dataset(cfg["data"], "test",
                           transform=transforms.make_eval_transform(
                               cfg["data"]["test"]["input_shape"], mean,
                               std))

    if CheckpointManager(args.work_dir).latest_step() is None:
        print("WARNING: no checkpoint found, evaluating random init")
    model = init_model(cfg, device="cpu" if args.cpu else None,
                       checkpoint_dir=args.work_dir)
    results, n = evaluate(model.module, ds, cfg["model"].get("eval", {}),
                          cfg.get("eval_disparity_id", (0,)))
    print(f"evaluated {n} samples:")
    print(metrics_table(results))
    has_conf = cfg["model"].get("cmn") is not None
    if args.out_dir or has_conf:
        curves, count = save_results(model, ds, args.out_dir, mean, std,
                                     cfg["model"].get("eval", {}))
        if count:
            print(sparsification_rows(curves, count))
            results.update({f"sparsification/{k}": v
                            for k, v in curves.items()})
        if args.out_dir:
            print(f"results saved to {args.out_dir}")
    return results, n


if __name__ == "__main__":
    main()
