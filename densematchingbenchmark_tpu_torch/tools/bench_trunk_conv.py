"""K4's bfloat16 route as the bfloat16 trunk calls it, split into its parts.

    python densematchingbenchmark_tpu_torch/tools/bench_trunk_conv.py \\
        [--root DIR] [--batches 1 4] [--forward] [--out FILE]

For each of the four stride-1 trunk shapes of the 384x1248 forward (the 13
conv + BN (+ ReLU) units of PSMAggregator) at each batch: a bfloat16
``ConvUnit`` in eval (folded BN, ReLU) under ``inference_mode``, as the
model runs it, by one call and over 20 in a row (CUDA events); the kernel's
own device time in that call (torch.profiler, kernel names containing
``conv3d_wgmma``) and all the call's launches; the per-call route
``conv3d_packed_s1(x, kernel, scale, bias, pack=1, relu=True)`` that
training takes, one call and chained; K5 (``conv3d_packed_s1_v2``) on
the same operands, chained and its device time; the kernel alone on
prepared operands, chained (where the port has the entry); cuDNN's bfloat16
F.conv3d + affine + ReLU by one call and chained (a yardstick the port does
not call), and the bound: the MACs at 989 TFLOP/s (H100 SXM, dense bf16)
against x and y in bfloat16 read and written once, the kernel once, the
float32 scale and bias, at 3.35 TB/s. The unit's result, and the route's
with ReLU on and off, are held against ``conv3d_packed_s1_plain`` within
one bfloat16 step.

``--forward`` adds the bfloat16 PSMNet/scene_flow forward at 384x1248 batch
1 (random weights, seed 0): the median of 11 single forwards (CUDA events),
its kernel launches and device busy time (torch.profiler), the K4 operand
builds of a new model's first three frames where the port counts them, and
``tools/bench.py``'s frames/s.

``--host`` adds the host's time a call of each layer of the eval unit's
call (the unit, the prepared entry, the launch, its pieces; cuDNN's conv
beside them) at a shape whose kernel takes a few microseconds.

``--root DIR`` imports the port from another checkout (the directory that
holds its ``densematchingbenchmark_tpu_torch``), so that two trees are
measured in one run on one card. Needs a GPU; prints one JSON line of the
results last (and writes it to ``--out``). ``chip_smoke.py`` runs
``measure_shape`` in its bfloat16 kernel phase.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

SHAPES = ((64, 32, (48, 96, 312), 1), (32, 32, (48, 96, 312), 6),
          (64, 64, (24, 48, 156), 3), (64, 64, (12, 24, 78), 3))
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12
BF16_STEP = 2.0 ** -7
CHAIN = 20
ONE_CALL_REPS = 21     # one call at a time: the median of these


def bound(b, d, h, w, cin, cout):
    """Least time of the call on the card (ms), and what sets it."""
    vox = b * d * h * w
    t_ops = 2 * 27 * cin * cout * vox / PEAK_BF16_FLOPS
    t_bytes = (2 * (vox * (cin + cout) + 27 * cin * cout)
               + 8 * cout) / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def time_ms(fn, reps=5):
    """Median time of one call of ``fn`` (CUDA events), after one."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def chained_ms(fn, n=CHAIN):
    """Time of one call of ``fn`` over ``n`` in a row, after one."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, match, n=10):
    """Device time a call of ``fn`` of the kernels whose name holds
    ``match``, and the kernel launches a call (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0
            and e.device_type.name == "CUDA"]
    ms = sum(e.self_device_time_total for e in rows
             if match in e.key) / 1e3 / n
    return ms, sum(e.count for e in rows) / n


def trunk_unit(cin, cout):
    """A bfloat16 trunk unit (conv, BN, ReLU; no conv bias) on the card in
    eval, BN drawn as the CPU tests draw it (scale 0.7-1.1, var 0.9-1.4,
    bias and mean 0.1 N(0, 1)) from a seed of its widths."""
    from densematchingbenchmark_tpu_torch.models.layers import ConvUnit
    unit = ConvUnit(cin, cout, 3, 1, 1, dims=3, relu=True, bias=False,
                    dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(cin * 1000 + cout)
    with torch.no_grad():
        bn = unit.BatchNorm_0
        bn.weight.copy_(torch.rand(cout, generator=gen) * 0.4 + 0.7)
        bn.running_var.copy_(torch.rand(cout, generator=gen) * 0.5 + 0.9)
        bn.bias.copy_(torch.randn(cout, generator=gen) * 0.1)
        bn.running_mean.copy_(torch.randn(cout, generator=gen) * 0.1)
    return unit.cuda().eval()


def measure_shape(batch, cin, cout, dhw, gen, profile=True):
    """The row of one trunk shape at ``batch`` (see the module's doc)."""
    from densematchingbenchmark_tpu_torch.ops.cuda import (
        conv3d_packed_s1, conv3d_packed_s1_plain)
    from densematchingbenchmark_tpu_torch.ops.cuda import \
        packed_conv3d_kernel as pk
    d, h, w = dhw
    unit = trunk_unit(cin, cout)
    x = torch.randn((batch, d, h, w, cin), device="cuda",
                    generator=gen).bfloat16()
    kernel = unit.Conv_0.weight.detach().permute(2, 3, 4, 1, 0) \
        .bfloat16().contiguous()
    scale, shift = (t.detach() for t in unit.folded_bn())

    # the calls run under inference mode, as the model's forward runs them
    # (entered once, not per call)
    with torch.inference_mode():
        call_unit = lambda: unit(x)
        call_route = lambda relu=True: conv3d_packed_s1(
            x, kernel, scale, shift, pack=1, relu=relu)
        err = 0.0
        for relu, got in ((True, call_unit), (True, call_route),
                          (False, lambda: call_route(False))):
            got = got().float()
            want = conv3d_packed_s1_plain(x, kernel, scale, shift, 1,
                                          relu).float()
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            tol = (1e-4 + BF16_STEP) * want.abs().max().item()
            assert e <= tol, (batch, cin, cout, d, relu, e, tol)
            err = max(err, e)
            del got, want
        row = {"max_abs_err": err,
               "unit_ms": time_ms(call_unit, ONE_CALL_REPS),
               "unit_chained_ms": chained_ms(call_unit)}
        if profile:
            row["kernel_device_ms"], row["unit_launches"] = device_ms(
                call_unit, "conv3d_wgmma")
        row["route_ms"] = time_ms(call_route, ONE_CALL_REPS)
        row["route_chained_ms"] = chained_ms(call_route)
        if profile:
            row["route_launches"] = device_ms(call_route, "conv3d_wgmma")[1]
        # K5, the same function on the same block in its own order
        k5 = lambda: pk.conv3d_packed_s1_v2(x, kernel, scale, shift, pack=1,
                                            relu=True)
        row["k5_chained_ms"] = chained_ms(k5)
        if profile:
            row["k5_device_ms"] = device_ms(k5, "conv3d_wgmma")[0]
        prepared = getattr(pk, "conv3d_packed_s1_prepared", None)
        if prepared is not None:
            operands = pk.wgmma_operands(kernel, scale, shift)
            row["kernel_chained_ms"] = chained_ms(lambda: prepared(
                x, operands, relu=True))
        w_oi = kernel.permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        x_cf = x.movedim(-1, 1)      # channels_last_3d storage, no copy
        s5, b5 = (t.view(1, -1, 1, 1, 1).bfloat16() for t in (scale, shift))
        lib = lambda: torch.relu(F.conv3d(x_cf, w_oi, padding=1) * s5 + b5)
        row["cudnn_ms"] = time_ms(lib, ONE_CALL_REPS)
        row["cudnn_chained_ms"] = chained_ms(lib)
        row["bound_ms"], row["bound_by"] = bound(batch, d, h, w, cin, cout)
        row["plain_ms"] = time_ms(lambda: conv3d_packed_s1_plain(
            x, kernel, scale, shift, 1, True), 3)
    return row


def device_context(device):
    with torch.cuda.device(device):
        pass


def enter_inference_mode():
    with torch.inference_mode():
        pass


def host_us(gen, n=2000):
    """Host time a call (perf_counter over ``n`` calls, microseconds) of
    each layer of the eval unit's call at a shape whose kernel takes a few
    microseconds (1x2x8x32, 64 -> 64 channels), so that the host sets the
    pace (``--host``)."""
    import time
    from densematchingbenchmark_tpu_torch.ops.cuda import (_build,
                                                           conv3d_packed_s1)
    from densematchingbenchmark_tpu_torch.ops.cuda import \
        packed_conv3d_kernel as pk
    unit = trunk_unit(64, 64)
    x = torch.randn((1, 2, 8, 32, 64), device="cuda",
                    generator=gen).bfloat16()
    kernel = unit.Conv_0.weight.detach().permute(2, 3, 4, 1, 0) \
        .bfloat16().contiguous()
    scale, shift = (t.detach() for t in unit.folded_bn())
    w_oi = kernel.permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    x_cf = x.movedim(-1, 1)
    steps = {"cuDNN F.conv3d alone": lambda: F.conv3d(x_cf, w_oi,
                                                      padding=1),
             "torch.empty": lambda: torch.empty(
                 (1, 2, 8, 32, 64), dtype=torch.bfloat16, device="cuda"),
             "torch.cuda.device": lambda: device_context(x.device),
             "current_stream": lambda: _build.current_stream(x.device)}
    with torch.inference_mode():
        steps["eval unit"] = lambda: unit(x)
    if hasattr(pk, "conv3d_packed_s1_prepared"):
        ops = pk.wgmma_operands(kernel, scale, shift)
        steps["prepared entry"] = lambda: pk.conv3d_packed_s1_prepared(
            x, ops, relu=True)
        steps["_launch"] = lambda: pk._launch(conv3d_packed_s1, x, ops,
                                              ops.scale, ops.bias, 1, True)
        steps["_check_volume"] = lambda: pk._check_volume(
            "conv3d_packed_s1_prepared", x, 64, 64, 1)
        lib = pk.library("conv3d_packed_s1")
        sms = pk._sm_count(x.device.index)
        steps["wgmma_dims"] = lambda: pk.wgmma_dims(
            pk.wgmma_plan, lib, "packed_conv3d", sms, 1, 2, 1, 8, 32, 64, 64,
            1)
        y = torch.empty_like(x)
        dims = pk.wgmma_dims(pk.wgmma_plan, lib, "packed_conv3d", sms, 1, 2,
                             1, 8, 32, 64, 64, 1)
        stream = _build.current_stream(x.device)
        steps["library call (ctypes, C)"] = lambda: lib.packed_conv3d_bf16(
            x.data_ptr(), ops.image.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), y.data_ptr(), dims, stream)
    steps["inference_mode"] = enter_inference_mode
    steps["per-call route"] = lambda: conv3d_packed_s1(
        x, kernel, scale, shift, pack=1, relu=True)
    out = {}
    for name, fn in steps.items():
        with torch.inference_mode(name == "eval unit"):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - t0) / n * 1e6
    return out


def forward(gen):
    """The bfloat16 forward at 384x1248 batch 1 (``--forward``)."""
    from densematchingbenchmark_tpu_torch.apis import init_model
    from densematchingbenchmark_tpu_torch.models.layers import ConvUnit
    from densematchingbenchmark_tpu_torch.tools import bench
    model = init_model("PSMNet/scene_flow_bf16", seed=0)
    x = torch.randn((1, 384, 1248, 3), device="cuda", generator=gen)
    fwd = {"ms": time_ms(lambda: model.forward(x, x), 11)}
    fwd["device_busy_ms"], fwd["launches"] = device_ms(
        lambda: model.forward(x, x), "", n=2)
    if hasattr(ConvUnit, "operand_builds"):
        fresh = init_model("PSMNet/scene_flow_bf16", seed=0)
        per_frame = []
        for _ in range(3):
            before = ConvUnit.operand_builds
            fresh.forward(x, x)
            per_frame.append(ConvUnit.operand_builds - before)
        fwd["operand_builds_per_frame"] = per_frame
    fwd["bench"] = bench.main([])
    return fwd


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", help="import the port from this checkout")
    p.add_argument("--batches", type=int, nargs="*", default=[1, 4],
                   help="batches of the per-shape rows (none: no rows)")
    p.add_argument("--forward", action="store_true")
    p.add_argument("--host", action="store_true",
                   help="the host's time a call, layer by layer")
    p.add_argument("--out")
    args = p.parse_args(argv)
    # this checkout, or --root, ahead of the script's own directory
    sys.path.insert(0, os.path.abspath(args.root) if args.root else
                    os.path.dirname(os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__)))))
    import densematchingbenchmark_tpu_torch as port
    from densematchingbenchmark_tpu_torch.ops.cuda import _build
    if not torch.cuda.is_available():
        sys.exit("bench_trunk_conv: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    tree = os.path.dirname(os.path.dirname(os.path.abspath(port.__file__)))
    print(f"bench_trunk_conv: port from {tree}; {smi}")
    _build.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {"tree": tree, "card": smi, "shapes": []}
    for batch in args.batches:
        for cin, cout, dhw, per_fwd in SHAPES:
            row = {"batch": batch, "cin": cin, "cout": cout, "dhw": dhw,
                   "per_forward": per_fwd,
                   **measure_shape(batch, cin, cout, dhw, gen)}
            results["shapes"].append(row)
            print(f"{cin}->{cout} {batch}x{'x'.join(map(str, dhw))} "
                  f"(x{per_fwd}/fwd): " + ", ".join(
                      f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                      for k, v in row.items() if k not in (
                          "batch", "cin", "cout", "dhw", "per_forward")))
            torch.cuda.empty_cache()
        rows = [r for r in results["shapes"] if r["batch"] == batch]
        total = {k: sum(r["per_forward"] * r[k] for r in rows)
                 for k in rows[0] if k.endswith("_ms")}
        results[f"forward_b{batch}"] = total
        print(f"13 launches a forward at batch {batch}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in total.items()))
    if args.host:
        results["host_us"] = host_us(gen)
        print("host us a call: " + ", ".join(
            f"{k} {v:.1f}" for k, v in results["host_us"].items()))
    if args.forward:
        results["forward"] = forward(gen)
        print(f"bf16 forward 1x384x1248: {results['forward']}")
    line = json.dumps(results)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return results


if __name__ == "__main__":
    main()
