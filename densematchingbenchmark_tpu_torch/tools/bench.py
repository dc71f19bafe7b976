"""Benchmark: PSMNet inference throughput on one GPU at 384x1248, batch 1.

    python -m densematchingbenchmark_tpu_torch.tools.bench [--dtype float32]

The port's counterpart of the repository's bench.py: PSMNet/scene_flow at
full width (random weights from seed 0) in ``--dtype`` compute, bfloat16 by
default as bench.py runs on an accelerator (bench.py:27-28); ITERS distinct
random frames staged on the device first, two warm-up forwards, then the
host clock around the ITERS forwards ended by a device synchronise.
Prints one JSON line with bench.py's keys: metric, value (frames/s),
unit, vs_baseline (over the reference's PSMNet on a GTX1080Ti at this
shape, 1.67 frames/s) and ms (per frame). The metric is bench.py's
``psmnet_inference_fps_384x1248_b1`` in bfloat16 and
``psmnet_inference_fps_384x1248_b1_f32`` in float32. It needs a GPU and
never falls back to the CPU.
"""

import argparse
import json
import time

import torch

from ..apis import init_model

BASELINE_FPS = 1.67     # the reference's README: PSMNet, GTX1080Ti
SHAPE = (384, 1248)
ITERS = 10
CONFIG = "PSMNet/scene_flow"


def metric_name(dtype):
    """bench.py's metric for bfloat16; float32's carries ``_f32``."""
    return (f"psmnet_inference_fps_{SHAPE[0]}x{SHAPE[1]}_b1"
            + ("_f32" if dtype == "float32" else ""))


def main(argv=None):
    """Returns the printed record."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help=f"compute dtype: bfloat16 reports "
                        f"{metric_name('bfloat16')}, float32 "
                        f"{metric_name('float32')}")
    args = p.parse_args(argv)
    model = init_model(CONFIG, seed=0, **{"model.dtype": args.dtype})
    gen = torch.Generator(device=model.device).manual_seed(1)
    frames = [tuple(torch.randn((1, *SHAPE, 3), device=model.device,
                                generator=gen) for _ in range(2))
              for _ in range(ITERS)]
    for left, right in frames[:2]:
        model.forward(left, right)
    torch.cuda.synchronize(model.device)
    t0 = time.perf_counter()
    outs = [model.forward(left, right)["disps"][0] for left, right in frames]
    torch.cuda.synchronize(model.device)
    dt = (time.perf_counter() - t0) / ITERS
    assert all(o.shape == (1, *SHAPE, 1) for o in outs)
    record = {"metric": metric_name(args.dtype),
              "value": round(1.0 / dt, 3), "unit": "frames/s/gpu",
              "vs_baseline": round(1.0 / dt / BASELINE_FPS, 3),
              "ms": round(dt * 1e3, 2)}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
