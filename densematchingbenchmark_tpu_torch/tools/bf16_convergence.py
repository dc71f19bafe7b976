"""Training convergence in bfloat16 against float32.

    python -m densematchingbenchmark_tpu_torch.tools.bf16_convergence \\
        [--config PSMNet/scene_flow] [--steps 500] [--height 256] \\
        [--width 512] [--batch 2] [--log-every 25] [--cpu]

Counterpart of the repository's tools/bf16_convergence.py:26-120. The
same model is trained twice on the same deterministic synthetic stream,
once with model.dtype float32 and once bfloat16 (float32 parameters and
BN statistics, bfloat16 compute; bfloat16 has float32's exponent range,
so there is no loss scaling), from random weights of seed 0. It reports
each loss curve, each dtype's step time (the mean of the steps after the
first two, each ending in the loss's ``.item()``), the tail's relative
difference (the mean of the last quarter of each curve) and the speed-up,
as one JSON line after the card's line. Runs on the GPU; ``--cpu`` runs
the plain versions on the CPU (host times); without either it raises.
``main(argv)`` returns the record.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..configs import get_config
from ..data import SyntheticStereoDataset, collate, transforms
from ..losses import make_loss_evaluator
from ..models import build_model
from ..trainer import TrainState, build_optimizer, make_train_step
from ..utils.collect_env import card_line
from .common import add_cpu_arg, float32_device, tool_device

KEYS = ("leftImage", "rightImage", "leftDisp")


def stream(cfg, height, width, batch):
    """batch_at(i): the i-th batch of the stream as numpy arrays, sample j
    drawn with rng default_rng((0, i, j)) from a 64-sample synthetic set
    at max_disp min(model.max_disp, 64)."""
    ds = SyntheticStereoDataset(
        length=64, height=height, width=width,
        max_disp=min(cfg["model"]["max_disp"], 64),
        transform=transforms.make_train_transform(
            (height, width), cfg["data"]["mean"], cfg["data"]["std"]))

    def batch_at(i):
        b = collate([ds.__getitem__((i * batch + j) % len(ds),
                                    rng=np.random.default_rng((0, i, j)))
                     for j in range(batch)])
        return {k: b[k] for k in KEYS}
    return batch_at


def run(cfg_name, dtype, steps, height, width, batch, log_every,
        device=None):
    """(loss curve [(step, loss)], mean step ms after the first two) of
    ``cfg_name`` in ``dtype``."""
    device = float32_device(device)
    cfg = get_config(cfg_name, **{"model.dtype": dtype})
    module = build_model(cfg, torch.Generator().manual_seed(0)).to(device)
    optimizer, _ = build_optimizer(cfg, module, steps)
    state = TrainState.create(module, optimizer, 1)
    step = make_train_step(make_loss_evaluator(
        cfg["model"]["losses"], sparse=False,
        cmn_losses_cfg=cfg["model"].get("cmn", {}).get("losses")))
    batch_at = stream(cfg, height, width, batch)

    curve = []
    t_total, timed_steps = 0.0, 0
    for i in range(steps):
        b = {k: torch.from_numpy(v).to(device)
             for k, v in batch_at(i).items()}
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        loss = metrics["loss"].item()   # the sync
        dt = time.perf_counter() - t0
        if i >= 2:   # past the kernels' first builds and the first step
            t_total += dt
            timed_steps += 1
        if i % log_every == 0 or i == steps - 1:
            curve.append((i, round(loss, 5)))
    return curve, (t_total / max(timed_steps, 1)) * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="PSMNet/scene_flow")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--log-every", type=int, default=25)
    add_cpu_arg(ap)
    args = ap.parse_args(argv)
    device = tool_device(args)
    print(card_line(), flush=True)

    out = {"config": args.config, "steps": args.steps,
           "shape": [args.height, args.width], "batch": args.batch}
    for dtype in ("float32", "bfloat16"):
        curve, step_ms = run(args.config, dtype, args.steps, args.height,
                             args.width, args.batch, args.log_every, device)
        out[dtype] = {"curve": curve, "step_ms": round(step_ms, 2),
                      "final_loss": curve[-1][1]}
        print(f"# {dtype}: final loss {curve[-1][1]:.4f}, "
              f"step {step_ms:.1f} ms", file=sys.stderr)

    f32, bf16 = out["float32"], out["bfloat16"]
    # the tail (last quarter), where the curves should have settled
    tail = max(1, len(f32["curve"]) // 4)
    tail_f32 = [v for _, v in f32["curve"][-tail:]]
    tail_bf16 = [v for _, v in bf16["curve"][-tail:]]

    def mean(xs):
        return sum(xs) / len(xs)
    out["tail_rel_diff"] = round(
        abs(mean(tail_bf16) - mean(tail_f32)) / max(abs(mean(tail_f32)),
                                                    1e-9), 4)
    out["speedup"] = round(f32["step_ms"] / bf16["step_ms"], 3)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
