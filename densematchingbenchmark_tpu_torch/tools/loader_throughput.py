"""The training data loader's rate, end to end, in samples/s.

    python -m densematchingbenchmark_tpu_torch.tools.loader_throughput \\
        [--n 48] [--workers 4] [--batch 3] [--epochs 2] [--workdir DIR] \\
        [--train-step-ms MS --train-step-batch B | --throughput-json F] \\
        [--cpu]

Counterpart of the repository's tools/loader_throughput.py:28-113. It
writes a SceneFlow-shaped set with the port's own writers (``--n`` pairs of
540x960 RGB PNGs, PFM disparities, a reference-format annotation JSON;
into ``--workdir``, kept and reused, or a temporary directory removed
after), then times the port's DataLoader over ``--epochs`` epochs after a
warm one: JSON annotations -> PNG / PFM decode -> random crop 256x512
and normalize -> collate -> the prefetch queue -> each batch copied to
the device as train_matcher copies it, the device synchronised at the
end. It prints samples/s and, given a train step to feed
(``--train-step-ms`` and ``--train-step-batch``, or the
``--throughput-json`` records of tools/train_throughput.py, whose
PSMNet/scene_flow row's bfloat16 step is read), the step's demand in
samples/s and the loader's margin over it; no step time is assumed. The
card's name and power limit print first. Runs on the GPU; ``--cpu`` stops
at the host (no copy to a device); without either it raises.
``main(argv)`` returns the record.
"""

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from ..data import DataLoader, transforms
from ..data.datasets import SceneFlowDataset
from ..data.io import save_pfm, save_png
from ..utils.collect_env import card_line
from .common import add_cpu_arg, device_label, tool_device

# the family whose train step the loader feeds (SceneFlow's crops)
FAMILY = "PSMNet/scene_flow"
MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)


def build_fake_sceneflow(root, n, h=540, w=960, seed=0):
    """Write ``n`` RGB PNG pairs, PFM disparities and a reference-format
    annotation JSON under ``root``; returns the annotation's path."""
    for sub in ("frames", "disparity"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rng = np.random.RandomState(seed)
    anns = []
    for i in range(n):
        item = {"left_image_path": f"frames/{i:04d}_L.png",
                "right_image_path": f"frames/{i:04d}_R.png",
                "left_disp_map_path": f"disparity/{i:04d}.pfm"}
        for key in ("left_image_path", "right_image_path"):
            save_png(os.path.join(root, item[key]),
                     (rng.rand(h, w, 3) * 255).astype(np.uint8))
        save_pfm(os.path.join(root, item["left_disp_map_path"]),
                 (rng.rand(h, w) * 192).astype(np.float32))
        anns.append(item)
    path = os.path.join(root, "annotations.json")
    with open(path, "w") as fp:
        json.dump(anns, fp)
    return path


def step_demand(args):
    """(train step ms, its batch) to compare with, or None."""
    if args.throughput_json:
        with open(args.throughput_json) as fp:
            records = json.load(fp)
        rec = next(r for r in records if r["family"] == FAMILY)
        return float(rec["bf16_ms"]), int(rec["batch"])
    if args.train_step_ms:
        return args.train_step_ms, args.train_step_batch
    return None


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir", default=None,
                   help="where the set is written (and reused); default: a "
                        "temporary directory, removed after")
    p.add_argument("--n", type=int, default=48)
    p.add_argument("--size", type=int, nargs=2, default=(540, 960),
                   help="the frames' height and width (SceneFlow's)")
    p.add_argument("--crop", type=int, nargs=2, default=(256, 512),
                   help="the train crop (the reference's)")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--batch", type=int, default=3)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--train-step-ms", type=float, default=None,
                   help="a measured train step, ms (no default: measure "
                        "it on the card with tools/train_throughput.py)")
    p.add_argument("--train-step-batch", type=int, default=3)
    p.add_argument("--throughput-json", default=None,
                   help="tools/train_throughput.py --out records: the "
                        f"{FAMILY} row's bfloat16 step and batch")
    add_cpu_arg(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = tool_device(args)
    print(card_line())
    root = args.workdir or tempfile.mkdtemp(prefix="dmb_loader_")
    try:
        ann = os.path.join(root, "annotations.json")
        if not os.path.exists(ann):
            print(f"writing {args.n} SceneFlow-shaped samples "
                  f"({args.size[0]}x{args.size[1]}) to {root}")
            ann = build_fake_sceneflow(root, args.n, *args.size)
        ds = SceneFlowDataset(ann, root, transform=(
            transforms.make_train_transform(tuple(args.crop), MEAN, STD)))
        loader = DataLoader(ds, args.batch, num_workers=args.workers,
                            prefetch=4)

        def run(epoch):
            n = 0
            for batch in loader.epoch(epoch):
                if device.type == "cuda":
                    for k in ("leftImage", "rightImage", "leftDisp"):
                        torch.from_numpy(batch[k]).to(device,
                                                      non_blocking=True)
                n += batch["leftImage"].shape[0]
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return n

        run(0)          # warm: the page cache, the thread pool
        t0 = time.perf_counter()
        samples = sum(run(ep) for ep in range(1, 1 + args.epochs))
        sps = samples / (time.perf_counter() - t0)
    finally:
        if args.workdir is None:
            shutil.rmtree(root, ignore_errors=True)
    record = {"metric": "loader_samples_per_sec", "value": round(sps, 3),
              "unit": "samples/s", "workers": args.workers,
              "batch": args.batch, "frame": list(args.size),
              "crop": list(args.crop), "device": device_label(device)}
    print(f"loader: {sps:.2f} samples/s ({1e3 / sps:.1f} ms a sample) with "
          f"{args.workers} workers, {args.size[0]}x{args.size[1]} -> crop "
          f"{args.crop[0]}x{args.crop[1]}, to {device_label(device)}")
    demand = step_demand(args)
    if demand:
        ms, b = demand
        need = b / (ms / 1e3)
        record["vs_train_step_demand"] = round(sps / need, 3)
        print(f"train step demand: {need:.2f} samples/s (step {ms} ms at "
              f"batch {b}); margin {sps / need:.2f}x "
              f"({'the loader keeps up' if sps > need else 'LOADER-BOUND'})")
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
