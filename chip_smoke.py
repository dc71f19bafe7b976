#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port (densematchingbenchmark_tpu_torch) through its own entry
points and holds every hand-written kernel of the path against its plain
PyTorch version on the card. Phases, each fatal on failure:

  1. device: needs CUDA; prints the card's name and power limit
     (nvidia-smi) and turns TF32 off for matmuls and cuDNN convolutions.
  2. build: compiles the CUDA C++ kernels from csrc/ (one nvcc per source,
     all at once) and prints the build seconds and ptxas's report.
  3. kernels: each kernel against its plain version at the shapes of the
     PSMNet path at 384x1248, with its time, its plain version's time, a
     one-call library yardstick where there is one, and its bound.
  4. slice: init_model("PSMNet/scene_flow_f32", seed=0) on cuda (random
     weights from the seed, full width) and inference_stereo over three
     random 375x1242 pairs padded to 384x1248, in both eval modes
     (model.eval.fused_upsample_argmin False: K1 + K2; True: K1 + K3),
     with the launch counts of each mode asserted, the two modes compared
     with each other and, on a small pair, with the same weights run
     through the plain versions on the CPU.

Prints a JSON line of per-kernel numbers before the last line, and as the
last line {"ok": true, "device": {...}}. Imports nothing of JAX.

    python3 chip_smoke.py --profile

adds, before the JSON lines, the device time of one forward in each mode
by kernel name (torch.profiler), and the device's busy share.
"""

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet): float32 on the CUDA cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# (Cin, Cout, (D, H, W), launches per forward) of the 13 stride-1
# conv+BN(+ReLU) units of PSMAggregator at 384x1248 (D = 192 / 4).
CONV_SHAPES = ((64, 32, (48, 96, 312), 1), (32, 32, (48, 96, 312), 6),
               (64, 64, (24, 48, 156), 3), (64, 64, (12, 24, 78), 3))
# soft-argmin over the full-resolution volume, 3 launches per forward
ARGMIN_SHAPE = (1, 192, 384, 1248)
# fused upsample + soft-argmin, low-res cost -> (out_d, out_h, out_w)
UPSAMPLE_LOW, UPSAMPLE_OUT = (1, 48, 96, 312), (192, 384, 1248)
IMAGE, PADDED, SMALL_IMAGE = (375, 1242), (384, 1248), (60, 120)
PAIRS, FORWARD_REPS = 3, 5

# Tolerances. The kernels and their plain versions both compute in float32
# and differ only in the order of their sums.
CONV_RTOL = 1e-4       # of max|plain|: 27 * Cin products summed in another order
ARGMIN_ATOL = 1e-3     # px: softmax sums over D in another order
MODES_ATOL = 2e-3      # px, 1e-5 of the 192 px range: K2 after a gather
                       # upsample vs K3's lerps in another order, through
                       # a softmax over random-weight costs
CPU_ATOL = 1e-2        # px: cuDNN vs CPU convolutions in the 2-D backbone and
                       # the strided 3-D convs, amplified through softmax

SOURCES = {
    "fused_conv3d": ("cuda", "densematchingbenchmark_tpu_torch/csrc/conv3d_kernel.cu",
                     "densematchingbenchmark_tpu/ops/pallas/conv3d_kernel.py:61"),
    "fused_soft_argmin": ("triton", "densematchingbenchmark_tpu_torch/ops/cuda/soft_argmin_kernel.py",
                          "densematchingbenchmark_tpu/ops/pallas/soft_argmin_kernel.py:34"),
    "fused_upsample_soft_argmin": ("cuda", "densematchingbenchmark_tpu_torch/csrc/upsample_argmin_kernel.cu",
                                   "densematchingbenchmark_tpu/ops/pallas/upsample_argmin_kernel.py:80"),
}


def bound_ms(flops, nbytes):
    """Least time for the work on the card, and what sets it."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def time_ms(fn, reps=5, warmup=1):
    """Median device time of one call of ``fn``, by CUDA events."""
    for _ in range(warmup):
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


def device_phase():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False); this script runs the port on the GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(smi)
    return smi


def build_phase():
    from densematchingbenchmark_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(logs) or 'nothing (already built)'}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


def check_conv(device, gen):
    """K1 against conv3d_plain at each trunk shape, relu both ways."""
    from densematchingbenchmark_tpu_torch.ops.cuda import (conv3d_plain,
                                                           fused_conv3d)
    rows = []
    for cin, cout, (d, h, w), per_fwd in CONV_SHAPES:
        x = torch.randn((1, d, h, w, cin), device=device, generator=gen)
        k = torch.randn((3, 3, 3, cin, cout), device=device,
                        generator=gen) * (27 * cin) ** -0.5
        scale = torch.rand(cout, device=device, generator=gen) + 0.5
        bias = torch.randn(cout, device=device, generator=gen)
        err = 0.0
        for relu in (True, False):
            got = fused_conv3d(x, k, scale, bias, relu=relu)
            want = conv3d_plain(x, k, scale, bias, relu)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            tol = CONV_RTOL * want.abs().max().item()
            assert e <= tol, (cin, cout, d, h, w, relu, e, tol)
            err = max(err, e)
        w_oi = k.permute(4, 3, 0, 1, 2).contiguous()
        x_cf = x.movedim(-1, 1)      # channels_last_3d storage, no copy
        s5, b5 = scale.view(1, -1, 1, 1, 1), bias.view(1, -1, 1, 1, 1)
        ms = time_ms(lambda: fused_conv3d(x, k, scale, bias, relu=True))
        plain = time_ms(lambda: conv3d_plain(x, k, scale, bias, True), 3)
        lib = time_ms(lambda: torch.relu(
            F.conv3d(x_cf, w_oi, padding=1) * s5 + b5))
        vox = d * h * w
        b_ms, b_by = bound_ms(2 * 27 * cin * cout * vox,
                              4 * (vox * (cin + cout) + k.numel() + 2 * cout))
        print(f"K1 fused_conv3d {cin}->{cout} {d}x{h}x{w} (x{per_fwd}/fwd): "
              f"{ms:.3f} ms, plain {plain:.3f}, F.conv3d {lib:.3f}, bound "
              f"{b_ms:.3f} ({b_by}), max_abs_err {err:.3g}")
        rows.append((per_fwd, ms, plain, lib, b_ms, err))
        del x, got, want
    total = lambda i: sum(r[0] * r[i] for r in rows)
    return {"unit": "per forward (13 launches at the 4 shapes)",
            "max_abs_err": max(r[5] for r in rows), "ms": total(1),
            "plain_ms": total(2), "library_ms": total(3),
            "bound_ms": total(4), "bound_by": "operations"}


def check_soft_argmin(device, gen):
    """K2 against soft_argmin_plain at the full-resolution volume."""
    from densematchingbenchmark_tpu_torch.ops.cost_volume import (
        disp_sample_values)
    from densematchingbenchmark_tpu_torch.ops.cuda import (fused_soft_argmin,
                                                           soft_argmin_plain)
    b, d, h, w = ARGMIN_SHAPE
    cost = torch.randn(ARGMIN_SHAPE, device=device, generator=gen) * 3
    err = 0.0
    # (max_disp, start_disp, dilation, alpha): the path's, then a linspace
    # range whose samples are not start + i * dilation
    for max_disp, start, dil, alpha in ((d, 0, 1, 1.0), (2 * d, -2, 2, 2.5)):
        vals = torch.as_tensor(disp_sample_values(max_disp, start, dil),
                               device=device)
        got = fused_soft_argmin(cost, max_disp, start, dil, alpha)
        want = soft_argmin_plain(cost, vals, alpha)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        assert got.shape == (b, h, w, 1) and e <= ARGMIN_ATOL, (max_disp, e)
        err = max(err, e)
    vals = torch.as_tensor(disp_sample_values(d), device=device)
    ms = time_ms(lambda: fused_soft_argmin(cost, d))
    plain = time_ms(lambda: soft_argmin_plain(cost, vals), 3)
    # per cost value: scale, max, subtract, exp, sum, multiply-add
    b_ms, b_by = bound_ms(6 * cost.numel(),
                          4 * (cost.numel() + d + b * h * w))
    print(f"K2 fused_soft_argmin {list(ARGMIN_SHAPE)} (x3/fwd): {ms:.3f} ms, "
          f"plain {plain:.3f}, bound {b_ms:.3f} ({b_by}), "
          f"max_abs_err {err:.3g}")
    return {"unit": "per launch", "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "library_ms": None, "bound_ms": b_ms,
            "bound_by": b_by}


def check_upsample(device, gen):
    """K3 against upsample_soft_argmin_plain at the path's shapes."""
    from densematchingbenchmark_tpu_torch.ops.cost_volume import (
        disp_sample_values)
    from densematchingbenchmark_tpu_torch.ops.cuda import (
        fused_upsample_soft_argmin, upsample_soft_argmin_plain)
    out_d, out_h, out_w = UPSAMPLE_OUT
    b, d_in = UPSAMPLE_LOW[:2]
    low = torch.randn(UPSAMPLE_LOW, device=device, generator=gen) * 3
    vals = torch.as_tensor(disp_sample_values(out_d), device=device)
    got = fused_upsample_soft_argmin(low, out_d, out_h, out_w)
    want = upsample_soft_argmin_plain(low, out_d, out_h, out_w, vals)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert got.shape == (b, out_h, out_w, 1) and err <= ARGMIN_ATOL, err
    ms = time_ms(lambda: fused_upsample_soft_argmin(low, out_d, out_h, out_w))
    plain = time_ms(lambda: upsample_soft_argmin_plain(
        low, out_d, out_h, out_w, vals), 3)

    def library():
        full = F.interpolate(low[:, None], size=UPSAMPLE_OUT,
                             mode="trilinear", align_corners=True)[:, 0]
        return (torch.softmax(full, 1) * vals.view(1, -1, 1, 1)).sum(1)

    lib = time_ms(library, 3)
    # per output pixel: 3 lerps (3 flops each) for each of the D' source
    # depths, then per upsampled depth a lerp, the scale, subtract, exp,
    # sum and multiply-add (8)
    pixels = b * out_h * out_w
    b_ms, b_by = bound_ms(pixels * (9 * d_in + 8 * out_d),
                          4 * (low.numel() + pixels + 4 * out_d
                               + 3 * (out_h + out_w)))
    print(f"K3 fused_upsample_soft_argmin {list(UPSAMPLE_LOW)} -> "
          f"{list(UPSAMPLE_OUT)} (x3/fwd): {ms:.3f} ms, plain {plain:.3f}, "
          f"interpolate+softmax {lib:.3f}, bound {b_ms:.3f} ({b_by}), "
          f"max_abs_err {err:.3g}")
    return {"unit": "per launch", "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
            "bound_by": b_by}


def random_pairs(rng, n, shape):
    return [{"leftImage": rng.rand(*shape, 3).astype(np.float32) * 255,
             "rightImage": rng.rand(*shape, 3).astype(np.float32) * 255}
            for _ in range(n)]


def run_mode(fused, pairs, device):
    """Build the model in one eval mode, drive inference_stereo over
    ``pairs`` with the launch counts read around it, then time forwards.
    Returns (model, disparities, counts)."""
    from densematchingbenchmark_tpu_torch.apis import (inference_stereo,
                                                       init_model)
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    model = init_model("PSMNet/scene_flow_f32", device=device, seed=0,
                       **{"model.eval.fused_upsample_argmin": fused})
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    results = inference_stereo(model, pairs, pad_to_shape=PADDED)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    n = len(pairs)
    assert counts["fused_conv3d"] == 13 * n, counts
    regress = "fused_upsample_soft_argmin" if fused else "fused_soft_argmin"
    other = "fused_soft_argmin" if fused else "fused_upsample_soft_argmin"
    assert counts[regress] == 3 * n and counts[other] == 0, counts
    disps = []
    for r in results:
        assert len(r["disps"]) == 3
        for d in r["disps"]:
            assert d.shape == (1, *IMAGE, 1) and np.isfinite(d).all(), \
                d.shape
        disps.append(r["disps"])

    x = torch.randn((1, *PADDED, 3), device=device)
    ms = time_ms(lambda: model.forward(x, x), FORWARD_REPS)
    print(f"slice fused_upsample_argmin={fused}: forward {ms:.2f} ms "
          f"(median of {FORWARD_REPS}, 1x{PADDED[0]}x{PADDED[1]}), peak "
          f"{peak:.2f} GiB, launches over {n} pairs {counts}")
    return model, disps, counts


def slice_phase(device="cuda"):
    rng = np.random.RandomState(0)
    pairs = random_pairs(rng, PAIRS, IMAGE)
    model_a, disps_a, counts_a = run_mode(False, pairs, device)
    model_b, disps_b, counts_b = run_mode(True, pairs, device)
    diff = max(float(np.abs(a - b).max())
               for da, db in zip(disps_a, disps_b) for a, b in zip(da, db))
    print(f"slice: eval modes agree to {diff:.3g} px (tolerance "
          f"{MODES_ATOL})")
    assert diff <= MODES_ATOL, diff

    # the same weights through the plain versions on the CPU, small pair
    from densematchingbenchmark_tpu_torch.apis import (StereoModel,
                                                       inference_stereo)
    cpu = StereoModel(model_a.cfg, copy.deepcopy(model_a.module).cpu(),
                      torch.device("cpu"))
    small = random_pairs(rng, 1, SMALL_IMAGE)
    pad = tuple(-(-s // 32) * 32 for s in SMALL_IMAGE)
    want = inference_stereo(cpu, small, pad_to_shape=pad)[0]["disps"]
    got = inference_stereo(model_a, small, pad_to_shape=pad)[0]["disps"]
    cpu_err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    print(f"slice: GPU vs CPU plain versions at {SMALL_IMAGE}: {cpu_err:.3g} "
          f"px (tolerance {CPU_ATOL})")
    assert cpu_err <= CPU_ATOL, cpu_err
    launches = {k: counts_a[k] + counts_b[k] for k in counts_a}
    return launches, (model_a, model_b)


def profile_phase(models, forwards=2, top=14):
    """Device time of the forward by kernel (torch.profiler), per mode."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn((1, *PADDED, 3), device="cuda")
    for model in models:
        model.forward(x, x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(forwards):
                model.forward(x, x)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / forwards
        # kernels only: device time of events that are not CPU-side ops
        rows = [(e.key, e.self_device_time_total / 1e3 / forwards,
                 e.count // forwards) for e in prof.key_averages()
                if e.self_device_time_total > 0 and e.device_type.name
                == "CUDA"]
        busy = sum(r[1] for r in rows)
        fused = model.module.fused_upsample_argmin
        print(f"profile fused_upsample_argmin={fused}: wall {wall:.2f} ms/"
              f"forward under the profiler, device busy {busy:.2f} ms "
              f"({100 * busy / wall:.1f}%), {len(rows)} kernel names")
        for key, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
            print(f"  {ms:8.3f} ms {count:4d}x  {key[:90]}")


def main():
    device_phase()
    build_phase()
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    gen = torch.Generator(device="cuda").manual_seed(0)
    stats = {"fused_conv3d": check_conv("cuda", gen),
             "fused_soft_argmin": check_soft_argmin("cuda", gen),
             "fused_upsample_soft_argmin": check_upsample("cuda", gen)}
    torch.cuda.empty_cache()
    launches, models = slice_phase()
    if "--profile" in sys.argv[1:]:
        profile_phase(models)
    rows = []
    for k in kernels.KERNELS:
        name = k.__name__
        route, source, replaces = SOURCES[name]
        assert launches[name] > 0, f"{name} never launched on the main path"
        rows.append({"name": name, "route": route, "source": source,
                     "replaces": replaces, "launches": launches[name],
                     **stats[name]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
