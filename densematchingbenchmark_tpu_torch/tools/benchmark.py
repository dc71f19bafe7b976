"""The model zoo's table: parameters, GFLOPs, forward latency and frames/s
of every family in one compute dtype, on one GPU.

    python -m densematchingbenchmark_tpu_torch.tools.benchmark \\
        [--models PSMNet/scene_flow ...] [--dtype float32] [--iters 10] \\
        [--height 384 --width 1248] [--train --batch 3] [--json] \\
        [--out zoo.json] [--cpu]

Counterpart of the repository's tools/benchmark.py:37-190. Each config is
built at full width with random weights from seed 0 (init_model) in
``--dtype`` compute; ``--iters`` distinct random frames are staged on the
device first, one forward warms up, and each forward is timed by CUDA
events: the latency is their median, the frames/s its inverse, beside the
reference's GTX1080Ti frames/s (BASELINES_FPS) where it published one.
DeepPruner runs at 384x1280 and PWCFlow at a width of 1280 when the
width is 1248 (their sides must be multiples of 64), as the JAX tool does.

GFLOPs are the matmul and convolution operations of one forward
(torch.utils.flop_counter: two a multiply-add; elementwise work is not
counted), counted over the plain route on fake CPU tensors (no data is
computed or allocated: the count depends only on the shapes), since the
port's kernels are not aten operations a counter on the card would see;
each trunk unit at its own widths (forward_flops).
``--train`` reports the training step instead (train_throughput's
measure_train_step at --height x --width and --batch). Rows print as
JSON lines, then the table (without ``--json``); ``--out`` writes them
with the run's settings and the card's line. The card's name and power
limit print first. Runs on the GPU; ``--cpu`` runs the plain versions on
the CPU, whose times are the host's; without either it raises.
``main(argv)`` returns the rows.
"""

import argparse
import json
import statistics

import torch

from ..apis import init_model
from ..configs import get_config
from ..models import build_model
from ..models.layers import ConvUnit
from ..utils.collect_env import card_line
from .common import add_cpu_arg, device_label, timed_ms, tool_device
from .train_throughput import measure_train_step

BASELINES_FPS = {  # GTX1080Ti, the reference's README (BASELINE.md)
    "PSMNet/scene_flow": 1.67,
    "AcfNet/scene_flow_adaptive": 1.38,
    "AcfNet/scene_flow_uniform": 1.66,
    "StereoNet/scene_flow_8x_2stage": 19.17,
    "StereoNet/scene_flow_8x_4stage": 8.54,
    "DeepPruner/scene_flow_4x": 3.42,
    "DeepPruner/scene_flow_8x": 7.67,
    "GCNet/scene_flow": None,
    "AnyNet/scene_flow": None,
    # the flow families: no reference baseline (its flow registry is empty)
    "PWCFlow/flying_chairs": None,
    "RAFT/flying_chairs": None,
}
WARMUP = 1


def frame_width(name, width):
    """The JAX tool's widths: DeepPruner at 1280 as the reference benches
    it, PWCFlow at 1280 for its 1/64 pyramid, when ``width`` is 1248."""
    if width == 1248 and name.startswith(("DeepPruner", "PWCFlow")):
        return 1280
    return width


def forward_flops(module, *shapes):
    """The matmul and convolution FLOPs (two a multiply-add) of
    ``module(*inputs)`` on inputs of ``shapes``, over the plain route on
    fake CPU tensors (FakeTensorMode): shapes only, no data computed or
    allocated (the port's kept tables keep nothing made under it,
    ops/kept.py). Each trunk unit of ``module`` is switched to the library
    conv and counted at its own widths (the zero channels its kernels are
    padded with are not the model's work)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    for unit in module.modules():
        if isinstance(unit, ConvUnit):
            unit.fusable = False
    with FakeTensorMode(allow_non_fake_inputs=True):
        inputs = [torch.empty(s) for s in shapes]
        with FlopCounterMode(display=False) as counter, \
                torch.inference_mode():
            module(*inputs)
    return counter.get_total_flops()


def count_flops(name, height, width):
    """forward_flops of one batch-1 eval forward of ``name`` at ``height``
    x ``width``, built in float32 on the CPU (the count is the same in
    every dtype)."""
    cfg = get_config(name, **{"model.dtype": "float32"})
    shape = (1, height, width, 3)
    return forward_flops(build_model(cfg).eval(), shape, shape)


def bench_one(name, height, width, dtype, iters, device):
    """One row: parameters, GFLOPs, the median forward ms and frames/s."""
    model = init_model(name, device=device, seed=0,
                       **{"model.dtype": dtype})
    n_params = sum(p.numel() for p in model.module.parameters())
    gen = torch.Generator(device=device).manual_seed(1)
    frames = [tuple(torch.randn((1, height, width, 3), device=device,
                                generator=gen) for _ in range(2))
              for _ in range(iters)]
    out_key = "flows" if model.cfg.get("task") == "flow" else "disps"
    for left, right in frames[:WARMUP]:
        model.forward(left, right)
    ms = []
    for left, right in frames:
        out, t = timed_ms(lambda: model.forward(left, right), device)
        ms.append(t)
        assert out[out_key][0].shape[1:3] == (height, width)
    latency = statistics.median(ms)
    ref = BASELINES_FPS.get(name)
    fps = 1e3 / latency
    return {"model": name, "dtype": dtype, "height": height, "width": width,
            "device": device_label(device), "params": n_params,
            "params_m": round(n_params / 1e6, 3),
            "gflops": round(count_flops(name, height, width) / 1e9, 1),
            "latency_ms": round(latency, 3),
            "fps": round(fps, 3), "ref_fps": ref,
            "vs_baseline": round(fps / ref, 2) if ref else None}


def table(rows):
    lines = [f"{'model':34s} {'params':>8s} {'GFLOPs':>9s} {'ms':>9s} "
             f"{'FPS':>8s} {'ref FPS':>8s} {'vs ref':>7s}"]
    for r in rows:
        if "error" in r:
            lines.append(f"{r['model']:34s} ERROR {r['error'][:70]}")
            continue
        vs = f"{r['vs_baseline']:.2f}x" if r["vs_baseline"] else "--"
        ref = f"{r['ref_fps']:.2f}" if r["ref_fps"] else "--"
        lines.append(f"{r['model']:34s} {r['params_m']:>7.3f}M "
                     f"{r['gflops']:>9.1f} {r['latency_ms']:>9.2f} "
                     f"{r['fps']:>8.2f} {ref:>8s} {vs:>7s}")
    return "\n".join(lines)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--models", nargs="*", default=list(BASELINES_FPS))
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--width", type=int, default=1248)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--train", action="store_true",
                   help="the training step instead of the forward")
    p.add_argument("--batch", type=int, default=3,
                   help="the training batch (the reference trains 3 a GPU)")
    p.add_argument("--json", action="store_true",
                   help="JSON lines only, no table")
    p.add_argument("--out", default=None,
                   help="write the rows and the run's settings as JSON")
    add_cpu_arg(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = tool_device(args)
    card = card_line()
    print(card)
    shapes = tuple((name, args.height, frame_width(name, args.width))
                   for name in args.models)
    rows = []
    for name, height, width in shapes:
        try:
            if args.train:
                row = measure_train_step(name, args.dtype, args.batch,
                                         height, width, args.iters,
                                         device)
            else:
                row = bench_one(name, height, width, args.dtype,
                                args.iters, device)
        except (RuntimeError, ValueError) as e:   # keep benching the rest
            row = {"model": name, "dtype": args.dtype,
                   "error": f"{type(e).__name__}: {e}"}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        meta = {"height": args.height, "width": args.width,
                "dtype": args.dtype, "iters": args.iters,
                "mode": "train" if args.train else "inference",
                "card": card, "device": device_label(device)}
        with open(args.out, "w") as fp:
            json.dump({"meta": meta, "rows": rows}, fp, indent=1)
    if not args.json and not args.train:
        print(table(rows))
    return rows


if __name__ == "__main__":
    main()
