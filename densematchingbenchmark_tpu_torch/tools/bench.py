"""Benchmark: PSMNet inference throughput on one GPU at 384x1248, batch 1,
float32.

    python -m densematchingbenchmark_tpu_torch.tools.bench

The port's counterpart of the repository's bench.py: PSMNet/scene_flow_f32
at full width (random weights from seed 0), ITERS distinct random frames
staged on the device first, two warm-up forwards, then the host clock
around the ITERS forwards ended by a device synchronise.
Prints one JSON line with bench.py's keys: metric, value (frames/s),
unit, vs_baseline (over the reference's PSMNet on a GTX1080Ti at this
shape, 1.67 frames/s) and ms (per frame). bench.py runs bfloat16 on an
accelerator; the port's bfloat16 compute is not ported yet (ROADMAP.md
queue 1 item 2), so this metric is named for float32. It needs a GPU and
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


def main(argv=None):
    """Returns the printed record."""
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(
        argv)
    model = init_model("PSMNet/scene_flow_f32", seed=0)
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
    record = {"metric": f"psmnet_inference_fps_{SHAPE[0]}x{SHAPE[1]}_b1_f32",
              "value": round(1.0 / dt, 3), "unit": "frames/s/gpu",
              "vs_baseline": round(1.0 / dt / BASELINE_FPS, 3),
              "ms": round(dt * 1e3, 2)}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
