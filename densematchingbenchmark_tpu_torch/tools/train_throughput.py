"""The training step's rate, family by family, in float32 and bfloat16,
on one GPU.

    python -m densematchingbenchmark_tpu_torch.tools.train_throughput \\
        [--iters 8] [--batch B] [--shape 256x512] [--only PSMNet] \\
        [--set key=value ...] [--out rows.json] [--cpu]

Counterpart of the repository's tools/train_throughput.py:57-223. For each
stereo family (FAMILIES) the full train step (make_train_step: the
forward in train mode, the losses, the gradients, the clip and optimizer
update, the BN statistics) at the reference's crop, 256x512, and each
config's own per-device batch (``data.batch_size_per_device``, unless
``--batch``), from random weights of seed 0: ``--iters`` distinct random
batches staged on the device, one step to warm up, then each step timed
by CUDA events. It prints step ms (the median) in each dtype and
samples/s, against the reference's published training rate a GPU where
there is one (REFERENCE_RATES: its SceneFlow wall-clocks on four
GTX1080Ti), one JSON record a family. The JAX tool's ``--with-unpacked``
timed a TPU schedule the port does not carry. The card's name and power
limit print first. Runs on the GPU; ``--cpu`` runs the plain versions on
the CPU (the host's times); without either it raises. ``main(argv)``
returns the records.
"""

import argparse
import json
import statistics

import numpy as np
import torch

from ..configs import get_config
from ..losses import make_loss_evaluator
from ..models import build_model
from ..trainer import TrainState, build_optimizer, make_train_step
from ..utils.collect_env import card_line
from .common import (add_cpu_arg, device_label, parse_overrides, timed_ms,
                     tool_device)

# samples/s a GPU = 35,454 SceneFlow train samples x epochs / (seconds x 4
# GPUs), from the reference's published wall-clocks (ResultOf*.md)
REFERENCE_RATES = {
    "PSMNet/scene_flow": 35454 * 10 / (81840.0 * 4),           # 22h44m/10ep
    "AcfNet/scene_flow_adaptive": 35454 * 20 / (484260.0 * 4),  # 134h31m/20ep
    "StereoNet/scene_flow_8x_2stage": 35454 * 11 / (147360.0 * 4),  # 40h56m
    "AnyNet/scene_flow": 35454 * 20 / (51120.0 * 4),           # 14h12m/20ep
}
FAMILIES = ("PSMNet/scene_flow", "AcfNet/scene_flow_adaptive",
            "AcfNet/scene_flow_uniform", "GCNet/scene_flow",
            "StereoNet/scene_flow_8x_2stage", "StereoNet/scene_flow_8x_4stage",
            "AnyNet/scene_flow", "DeepPruner/scene_flow_4x",
            "DeepPruner/scene_flow_8x")
DTYPES = ("float32", "bfloat16")
WARMUP = 1


def train_setup(cfg, module, batch, height, width, n, device):
    """(TrainState, make_train_step's step, ``n`` distinct random batches
    staged on ``device``) of ``module`` built from ``cfg``: images
    uniform in [0, 1), disparities in [1, 161)."""
    optimizer, _ = build_optimizer(cfg, module, 1000)
    state = TrainState.create(module, optimizer, seed=1)
    step = make_train_step(make_loss_evaluator(
        cfg["model"]["losses"], sparse=cfg["data"].get("sparse", False),
        cmn_losses_cfg=cfg["model"].get("cmn", {}).get("losses")))
    gen = torch.Generator(device=device).manual_seed(2)

    def rand(c):
        return torch.rand((batch, height, width, c), device=device,
                          generator=gen)
    batches = [{"leftImage": rand(3), "rightImage": rand(3),
                "leftDisp": rand(1) * 160 + 1} for _ in range(n)]
    return state, step, batches


def measure_train_step(name, dtype, batch, height, width, iters, device,
                       overrides=None):
    """One row: the median step ms and samples/s of ``name`` in ``dtype``
    at batch x height x width (``batch`` None: the config's own)."""
    cfg = get_config(name, **dict(overrides or {}, **{"model.dtype": dtype}))
    if batch is None:
        batch = int(cfg["data"].get("batch_size_per_device", 3))
    module = build_model(cfg, torch.Generator().manual_seed(0)).to(device)
    state, step, batches = train_setup(cfg, module, batch, height, width,
                                       iters, device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for i in range(WARMUP):
        state, metrics = step(state, batches[i % iters])
    assert np.isfinite(float(metrics["loss"])), (name, dtype)
    ms = []
    for b in batches:
        (state, metrics), t = timed_ms(lambda: step(state, b), device)
        ms.append(t)
    assert np.isfinite(float(metrics["loss"])), (name, dtype)
    step_ms = statistics.median(ms)
    row = {"model": name, "dtype": dtype, "batch": batch,
           "shape": f"{height}x{width}", "device": device_label(device),
           "step_ms": round(step_ms, 3),
           "samples_per_s": round(batch * 1e3 / step_ms, 3)}
    if torch.device(device).type == "cuda":
        row["peak_mem_gib"] = round(
            torch.cuda.max_memory_allocated(device) / 2 ** 30, 3)
    return row


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--batch", type=int, default=None,
                   help="per-device batch; default: each config's own "
                        "batch_size_per_device (the reference's "
                        "imgs_per_gpu)")
    p.add_argument("--shape", default="256x512",
                   help="the crop, HxW (the reference's train crop)")
    p.add_argument("--only", default=None, help="a substring of the names")
    p.add_argument("--set", action="append", default=[], dest="sets",
                   help="a config override key=value (a Python literal)")
    p.add_argument("--out", default=None, help="write the records as JSON")
    add_cpu_arg(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = tool_device(args)
    card = card_line()
    print(card)
    h, w = (int(x) for x in args.shape.split("x"))
    overrides = parse_overrides(args.sets)
    print(f"train step at {h}x{w} (forward, losses, gradients, update), "
          f"{device_label(device)}")
    print(f"{'family':34s} {'batch':>5s} {'f32 ms':>9s} {'bf16 ms':>9s} "
          f"{'sps bf16':>9s} {'ref sps':>8s} {'vs ref':>7s}")
    records = []
    for name in FAMILIES:
        if args.only and args.only not in name:
            continue
        rec = {"metric": "train_samples_per_sec_per_gpu", "family": name,
               "shape": f"{h}x{w}", "card": card}
        for dtype in DTYPES:
            key = "f32" if dtype == "float32" else "bf16"
            try:
                row = measure_train_step(name, dtype, args.batch, h, w,
                                         args.iters, device, overrides)
            except torch.cuda.OutOfMemoryError:
                rec[f"{key}_ms"] = "OOM"
                continue
            finally:
                if device.type == "cuda":
                    torch.cuda.empty_cache()
            rec.update({"batch": row["batch"], f"{key}_ms": row["step_ms"],
                        f"{key}_samples_per_s": row["samples_per_s"]})
            if "peak_mem_gib" in row:
                rec[f"{key}_peak_mem_gib"] = row["peak_mem_gib"]
        ref = REFERENCE_RATES.get(name)
        sps = rec.get("bf16_samples_per_s")
        if ref:
            rec["ref_samples_per_sec_per_gpu"] = round(ref, 3)
            if sps:
                rec["vs_baseline"] = round(sps / ref, 2)
        records.append(rec)
        cols = [rec.get(k, "-") for k in ("f32_ms", "bf16_ms",
                                           "bf16_samples_per_s")]
        print(f"{name:34s} {rec.get('batch', '-')!s:>5s} "
              + " ".join(f"{v:9.1f}" if isinstance(v, float) else f"{v:>9s}"
                         for v in cols)
              + (f" {ref:8.2f} {sps / ref:6.1f}x" if ref and sps else
                 f" {(f'{ref:.2f}' if ref else '--'):>8s} {'--':>7s}"))
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as fp:
            json.dump(records, fp, indent=1)
    return records


if __name__ == "__main__":
    main()
