"""Profile a model's forward, or its train step, by kernel, on one GPU.

    python -m densematchingbenchmark_tpu_torch.tools.profile_model \\
        --config DeepPruner/scene_flow_4x [--height 384 --width 1280] \\
        [--iters 3] [--dtype bfloat16] [--out trace.json] \\
        [--set key=value ...] [--train --batch 3] [--cpu]

Counterpart of the repository's tools/profile_model.py:20-171, whose
xplane reader is TPU-only. The model is built at full width with random
weights from seed 0 in ``--dtype`` compute; one forward (or train step)
runs outside the profile, then torch.profiler, with CUDA activity, traces
``--iters`` more on distinct inputs staged on the device first (``--train``:
make_train_step at --batch on random batches at --height x --width, as
train_throughput builds them) and writes a Chrome trace to ``--out``. It
prints the 20 device kernels that take the most time (self time, by name),
the device's busy share of the wall time under the profiler and the
launch count a call. The card's name and power limit print first. Runs on
the GPU; ``--cpu`` profiles the plain versions on the CPU, by host
operator; without either it raises. ``main(argv)`` returns
``device_profile``'s summary.
"""

import argparse
import time

import torch

from ..apis import init_model
from ..utils.collect_env import card_line
from .common import add_cpu_arg, parse_overrides, tool_device


def device_profile(label, fn, reps=2, top=14, convs=0, named=None,
                   trace=None, device="cuda"):
    """Device time of one call of ``fn`` by kernel name (torch.profiler),
    after one call outside the profile; with ``convs``, also the ``convs``
    convolution ops (forward or backward, by input shapes) that take the
    most device time, their kernels included; with ``named`` ({label:
    weight shape}), the device time of the convolution ops (forward and
    backward, their kernels included) of each weight shape; with
    ``trace``, the Chrome trace written there. On a CPU ``device`` it
    profiles the host's operators instead (their self CPU time). Returns
    {'wall_ms', 'busy_ms', 'launches', 'kernels': [(name, ms, count) a
    call, the most time first]}."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    fn()
    if cuda:
        torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities,
                 record_shapes=bool(convs or named)) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if cuda:
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    if trace:
        prof.export_chrome_trace(trace)
    if cuda:
        # kernels only: device time of events that are not CPU-side ops
        rows = [(e.key, e.self_device_time_total / 1e3 / reps,
                 e.count // reps) for e in prof.key_averages()
                if e.self_device_time_total > 0
                and e.device_type.name == "CUDA"]
        what = "device busy"
    else:
        rows = [(e.key, e.self_cpu_time_total / 1e3 / reps, e.count // reps)
                for e in prof.key_averages() if e.self_cpu_time_total > 0]
        what = "host operators' self time"
    busy = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    rows.sort(key=lambda r: -r[1])
    print(f"profile {label}: wall {wall:.2f} ms per call under the "
          f"profiler, {what} {busy:.2f} ms ({100 * busy / wall:.1f}%), "
          f"{launches} {'kernel launches' if cuda else 'operator calls'} "
          f"of {len(rows)} names")
    wgmma = [r for r in rows if "conv3d_wgmma" in r[0]]
    if wgmma:
        print(f"  K4/K5 bfloat16 block (conv3d_wgmma): "
              f"{sum(r[1] for r in wgmma):.3f} ms of device time, "
              f"{sum(r[2] for r in wgmma)} launches")
    for key, ms, count in rows[:top]:
        print(f"  {ms:8.3f} ms {count:4d}x  {key[:90]}")
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.key in ("aten::convolution", "aten::convolution_backward")]
    for e in sorted(ops, key=lambda e: -e.device_time_total)[:convs]:
        print(f"  {e.device_time_total / 1e3 / reps:8.3f} ms "
              f"{e.count // reps:4d}x  {e.key} {e.input_shapes[:3]}")
    for name, weight in (named or {}).items():
        # the weight is the second input of a forward, the third of a
        # backward (grad_output, input, weight, ...)
        hits = [e for e in ops if weight in [list(s) for s in
                                             e.input_shapes[1:3]]]
        ms = sum(e.device_time_total for e in hits) / 1e3 / reps
        print(f"  {name}: {ms:.3f} ms of device time, "
              f"{sum(e.count for e in hits) // reps} ops "
              f"({', '.join(sorted({e.key for e in hits}))})")
    return {"wall_ms": wall, "busy_ms": busy, "launches": launches,
            "kernels": rows}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="DeepPruner/scene_flow_4x")
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--out", default="profile_trace.json",
                   help="the Chrome trace (chrome://tracing, Perfetto)")
    p.add_argument("--set", action="append", default=[], dest="sets",
                   help="a config override key=value (a Python literal)")
    p.add_argument("--train", action="store_true",
                   help="profile the train step (forward, losses, "
                        "gradients, update) instead of the forward")
    p.add_argument("--batch", type=int, default=3,
                   help="the train step's batch (the reference's "
                        "imgs_per_gpu)")
    add_cpu_arg(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = tool_device(args)
    print(card_line())
    overrides = dict(parse_overrides(args.sets), **{"model.dtype":
                                                    args.dtype})
    h, w = args.height, args.width
    model = init_model(args.config, device=device, seed=0, **overrides)
    if args.train:
        from .train_throughput import train_setup
        state, step, inputs = train_setup(model.cfg, model.module,
                                          args.batch, h, w, args.iters + 1,
                                          device)

        def call(b):
            step(state, b)
        label = f"{args.config} {args.dtype} train step {args.batch}x{h}x{w}"
    else:
        gen = torch.Generator(device=device).manual_seed(1)
        inputs = [tuple(torch.randn((1, h, w, 3), device=device,
                                    generator=gen) for _ in range(2))
                  for _ in range(args.iters + 1)]

        def call(pair):
            model.forward(*pair)
        label = f"{args.config} {args.dtype} forward 1x{h}x{w}"
    feed = iter(inputs)
    summary = device_profile(label, lambda: call(next(feed)),
                             reps=args.iters, top=20, trace=args.out,
                             device=device)
    print(f"trace -> {args.out}")
    return summary


if __name__ == "__main__":
    main()
