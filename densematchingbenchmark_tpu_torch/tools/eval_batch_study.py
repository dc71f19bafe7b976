"""Batched evaluation's wall clock: batch 1 against batch N.

    python -m densematchingbenchmark_tpu_torch.tools.eval_batch_study \\
        [--config StereoNet/scene_flow_8x_2stage] [--n 64] \\
        [--batches 1 4 8] [--height 384 --width 1248] [--dtype bfloat16] \\
        [--cache] [--device-resident] [--cpu]

Counterpart of the repository's tools/eval_batch_study.py:1-132. It
evaluates ``--n`` samples of a synthetic SceneFlow-like set through the
port's ``evaluation.evaluate`` (shape buckets, loader threads, pinned
copies, one fetch at the end) at each batch size of ``--batches``, with
seeded random weights at the config's full width, and reports the wall
clock a sample and each run's EPE, which batching must not change.
Batch 1 pays a dispatch of the forward and the metrics a sample; a batch
amortises them. ``--cache`` decodes every sample first (no host decode in
the timed loop); ``--device-resident`` stages every batch on the device
first (``to_device``) and times only the eval steps and the one fetch at
the end. Each size runs once untimed first (the kernels' builds, cuDNN's
choices, the kept operands).

The card's name and power limit print first, a line a batch size next,
and JAX's JSON keys on the last line. Runs on the GPU; ``--cpu`` runs the
plain versions on the CPU (host times); without either it raises.
``main(argv)`` returns the record, the EPEs unrounded.
"""

import argparse
import json
import time

import torch

from ..configs import get_config
from ..data import SyntheticStereoDataset, collate, transforms
from ..evaluation.eval_loop import (average_metrics, evaluate,
                                    make_eval_metrics_step, to_device)
from ..models import build_model
from ..utils.collect_env import card_line
from .common import add_cpu_arg, device_label, tool_device


class Cached:
    """A dataset's samples, decoded once."""

    def __init__(self, dataset):
        self.samples = [dataset[i] for i in range(len(dataset))]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i, rng=None):
        return self.samples[i]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="StereoNet/scene_flow_8x_2stage")
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--batches", type=int, nargs="*", default=[1, 4, 8])
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--width", type=int, default=1248)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--cache", action="store_true",
                   help="decode every sample first (no host decode cost)")
    p.add_argument("--device-resident", action="store_true",
                   help="stage every batch on the device first and time "
                        "only the eval steps and the one fetch at the end")
    add_cpu_arg(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = tool_device(args)
    print(card_line())
    cfg = get_config(args.config, **{"model.dtype": args.dtype})
    module = build_model(cfg, torch.Generator().manual_seed(0))
    module.to(device).eval()
    data = cfg["data"]
    ds = SyntheticStereoDataset(
        length=args.n, height=args.height, width=args.width,
        max_disp=min(cfg["model"]["max_disp"], 64),
        transform=transforms.make_eval_transform(
            (args.height, args.width), data["mean"], data["std"]))
    if args.cache:
        ds = Cached(ds)
    eval_cfg = cfg["model"].get("eval", {})

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    results = {}
    for bsz in args.batches:
        step = make_eval_metrics_step(module, eval_cfg.get("lower_bound", 0),
                                      eval_cfg.get("upper_bound", 192), (0,))
        if args.device_resident:
            batches = [(to_device(collate([ds[i] for i in range(
                i0, min(i0 + bsz, args.n))]), device),
                min(bsz, args.n - i0)) for i0 in range(0, args.n, bsz)]
            average_metrics([(step(b), n) for b, n in batches[:2]],
                            sum(n for _, n in batches[:2]))   # warm
            sync()
            t0 = time.perf_counter()
            metrics = average_metrics([(step(b), n) for b, n in batches],
                                      args.n)
            dt = time.perf_counter() - t0
        else:
            evaluate(module, ds, eval_cfg, batch_size=bsz, step=step)
            sync()
            t0 = time.perf_counter()
            metrics, _ = evaluate(module, ds, eval_cfg, batch_size=bsz,
                                  step=step)
            dt = time.perf_counter() - t0
        results[bsz] = (dt, metrics["disp_0/epe"])
        print(f"batch {bsz}: {dt * 1e3:8.1f} ms total, "
              f"{dt / args.n * 1e3:6.2f} ms/sample, "
              f"epe={metrics['disp_0/epe']:.4f}", flush=True)

    out = {"config": args.config, "n": args.n,
           "shape": [args.height, args.width], "dtype": args.dtype,
           "device": device_label(device)}
    for bsz in args.batches:
        dt, epe = results[bsz]
        out[f"batch{bsz}_ms_per_sample"] = dt / args.n * 1e3
        out[f"batch{bsz}_epe"] = epe
    out["speedup"] = (results[args.batches[0]][0]
                      / results[args.batches[-1]][0])
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
