"""Evaluate a stereo model over a test set; optionally save the results.

    python -m densematchingbenchmark_tpu_torch.tools.test \\
        --config PSMNet/kitti_2015_f32 --work-dir work/psmnet \\
        --data-root /data/KITTI-2015 --annfile /data/kitti15_val.json \\
        [--out-dir results] [--override data.test.use_right_disp=True] [--cpu]

The counterpart of the JAX package's tools/test.py for stereo models:
the test split's file dataset (or ``--synthetic``) through the eval
transform, the model restored from <work-dir>/checkpoints/ (seeded random
weights, with a warning, when there is none), the batched evaluation on the
device, and the metric table. ``--out-dir`` writes, per sample, the KITTI
submission PNG, the colour map and the 2x2 panel, cropped to the sample's
original size. Runs on the GPU unless ``--cpu``; with neither it raises.
Flow configs (ROADMAP.md queue 1 item 11), confidence outputs (item 6) and
multi-process launchers (item 5) are not ported and raise.
"""

import argparse

import numpy as np

from ..apis import init_model
from ..configs import get_config
from ..data import SyntheticStereoDataset, build_dataset, collate, transforms
from ..evaluation.eval_loop import evaluate, to_device
from ..evaluation.format import metrics_table
from ..evaluation.metrics import remove_padding
from ..utils.checkpoint import CheckpointManager
from ..visualization import SaveResultTool
from .common import add_distributed_args, check_launcher, parse_overrides


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a dense matching model")
    p.add_argument("--config", required=True)
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
    add_distributed_args(p)
    return p.parse_args(argv)


def save_results(model, ds, out_dir, mean, std):
    """Batch-1 forward of every sample; its best disparity, GT and left
    image at the sample's original size through SaveResultTool."""
    save = SaveResultTool(out_dir)
    for i in range(len(ds)):
        batch = collate([ds[i]])
        h, w = batch["original_size"]
        x = to_device(batch, model.device)
        disp = model.forward(x["leftImage"], x["rightImage"])["disps"][0]
        gt = batch.get("leftDisp")
        left = batch["leftImage"] * np.asarray(std, np.float32) + \
            np.asarray(mean, np.float32)
        save(f"{i:06d}", remove_padding(disp.float().cpu().numpy(), h, w),
             None if gt is None else remove_padding(gt, h, w),
             remove_padding(left, h, w))


def main(argv=None):
    """Returns ({f'disp_{id}/{metric}': mean}, samples)."""
    args = parse_args(argv)
    check_launcher(args)
    cfg = get_config(args.config, **parse_overrides(args.override))
    if cfg.get("task") == "flow":
        raise NotImplementedError("flow evaluation is not ported yet "
                                  "(ROADMAP.md queue 1 item 11)")
    if cfg["model"].get("cmn") is not None:
        raise NotImplementedError("confidence outputs and sparsification "
                                  "are not ported yet (ROADMAP.md queue 1 "
                                  "item 6)")
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
    if args.out_dir:
        save_results(model, ds, args.out_dir, mean, std)
        print(f"results saved to {args.out_dir}")
    return results, n


if __name__ == "__main__":
    main()
