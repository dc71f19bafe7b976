#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port (densematchingbenchmark_tpu_torch) through its own entry
points and holds every hand-written kernel of its paths against its plain
PyTorch version on the card. Phases, each fatal on failure:

  1. device: needs CUDA; prints the card's name and power limit
     (nvidia-smi) and turns TF32 off for matmuls and cuDNN convolutions.
  2. build: compiles the CUDA C++ kernels from csrc/ (one nvcc per source,
     all at once) and prints the build seconds and ptxas's report.
  3. kernels: each kernel against its plain version at the shapes of its
     path (K1, K2, K3 at the 384x1248 inference shapes; K4 forward and
     backward and the K2 backward at the 256x512 batch-3 training shapes),
     with its time, its plain version's time, a one-call library yardstick
     where there is one, and its bound.
  4. slice: init_model("PSMNet/scene_flow_f32", seed=0) on cuda (random
     weights from the seed, full width) and inference_stereo over three
     random 375x1242 pairs padded to 384x1248, in both eval modes
     (model.eval.fused_upsample_argmin False: K1 + K2; True: K1 + K3),
     with the launch counts of each mode asserted, the two modes compared
     with each other and, on a small pair, with the same weights run
     through the plain versions on the CPU.
  5. train: trainer.loop.train_matcher on PSMNet/scene_flow_f32 at full
     width, its own 256x512 crop and batch 3 of SyntheticStereoDataset, for
     5 steps, with the launches per step asserted (K4 13, K2 3 forward and
     3 backward, K1 and K3 none), finite losses, the step time, samples/s,
     peak memory and the checkpoint's resume position.
  6. same weights: one train step at a small size on the card and on the
     CPU (the plain versions) from the same weights and batch: loss,
     per-parameter gradient cosine and updated parameters.
  7. overfit: 24 train steps on one batch at a tiny size (max_disp 32,
     crop 64x96, lr 2e-3, no warmup); the loss must fall below 0.7x its
     first value and the batch's EPE must fall.

Prints a JSON line of per-kernel numbers before the last line, and as the
last line {"ok": true, "device": {...}}. Imports nothing of JAX.

    python3 chip_smoke.py --profile

adds, before the JSON lines, the device time by kernel name
(torch.profiler) and the device's busy share of one forward in each eval
mode and of one training step at 256x512 batch 3.
"""

import copy
import json
import subprocess
import sys
import tempfile
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

# Training: batch 3 of the config's 256x512 crop. (Cin, Cout, (D, H, W),
# launches per step) of the 13 stride-1 trunk units (K4, pack 1), and the
# full-resolution cost volumes of the regression (K2 forward and backward,
# 3 launches each per step).
TRAIN_BATCH, TRAIN_STEPS = 3, 5
TRAIN_CONV_SHAPES = ((64, 32, (48, 64, 128), 1), (32, 32, (48, 64, 128), 6),
                     (64, 64, (24, 32, 64), 3), (64, 64, (12, 16, 32), 3))
TRAIN_ARGMIN_SHAPE = (3, 192, 256, 512)
# the small configuration of the same-weights and overfit phases
SMALL = {"model.max_disp": 32,
         "model.cost_processor.cost_computation.max_disp": 8,
         "model.cost_processor.cost_aggregator.max_disp": 32,
         "model.disp_predictor.max_disp": 32,
         "model.losses.l1_loss.max_disp": 32,
         "data.batch_size_per_device": 2}
OVERFIT_STEPS = 24

# Tolerances. The kernels and their plain versions both compute in float32
# and differ only in the order of their sums.
CONV_RTOL = 1e-4       # of max|plain|: 27 * Cin products summed in another order
ARGMIN_ATOL = 1e-3     # px: softmax sums over D in another order
MODES_ATOL = 2e-3      # px, 1e-5 of the 192 px range: K2 after a gather
                       # upsample vs K3's lerps in another order, through
                       # a softmax over random-weight costs
CPU_ATOL = 1e-2        # px: cuDNN vs CPU convolutions in the 2-D backbone and
                       # the strided 3-D convs, amplified through softmax
CONV_GRAD_RTOL = 1e-3  # of max|plain|: gradient sums over up to 1.2 M
                       # products (B*D*H*W) in another order
ARGMIN_GRAD_RTOL = 1e-4  # of max|plain|: the expectation E from the online
                       # softmax vs the plain one, ~1e-6 of the 192 px range,
                       # in alpha * g * p_d * (v_d - E)
TRAIN_LOSS_RTOL = 1e-3   # card vs CPU loss, cuDNN vs CPU convolutions
TRAIN_GRAD_COS = 0.999   # card vs CPU per-parameter gradient cosine

SOURCES = {
    "fused_conv3d": ("cuda", "densematchingbenchmark_tpu_torch/csrc/conv3d_kernel.cu",
                     "densematchingbenchmark_tpu/ops/pallas/conv3d_kernel.py:61"),
    "fused_soft_argmin": ("triton", "densematchingbenchmark_tpu_torch/ops/cuda/soft_argmin_kernel.py",
                          "densematchingbenchmark_tpu/ops/pallas/soft_argmin_kernel.py:34"),
    "fused_upsample_soft_argmin": ("cuda", "densematchingbenchmark_tpu_torch/csrc/upsample_argmin_kernel.cu",
                                   "densematchingbenchmark_tpu/ops/pallas/upsample_argmin_kernel.py:80"),
    # JAX differentiates K2's function with XLA (ops/soft_argmin.py:21-47)
    "fused_soft_argmin_backward": ("triton", "densematchingbenchmark_tpu_torch/ops/cuda/soft_argmin_kernel.py",
                                   "densematchingbenchmark_tpu/ops/pallas/soft_argmin_kernel.py:34"),
    "conv3d_packed_s1": ("cuda", "densematchingbenchmark_tpu_torch/csrc/packed_conv3d_kernel.cu",
                         "densematchingbenchmark_tpu/ops/pallas/packed_conv3d_kernel.py:197"),
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


def epilogue(form, pack, cout, device, gen):
    """A scalar, [Co] or [pack*Co] (scale, bias) pair."""
    n = {"scalar": (), "co": (cout,), "pco": (pack * cout,)}[form]
    return (torch.rand(n, device=device, generator=gen) + 0.5,
            torch.randn(n, device=device, generator=gen))


def check_packed_conv(device, gen):
    """K4 against conv3d_packed_s1_plain at each training trunk shape, with
    pack 1 (the path) and pack 4 and every epilogue form; its backward
    against autograd of the plain version."""
    from densematchingbenchmark_tpu_torch.ops.conv3d import pack_volume
    from densematchingbenchmark_tpu_torch.ops.cuda import (
        conv3d_packed_s1, conv3d_packed_s1_plain)
    rows = []
    for cin, cout, (d, h, w), per_step in TRAIN_CONV_SHAPES:
        x = torch.randn((TRAIN_BATCH, d, h, w, cin), device=device,
                        generator=gen)
        k = torch.randn((3, 3, 3, cin, cout), device=device,
                        generator=gen) * (27 * cin) ** -0.5
        err = 0.0
        for pack, form, relu in ((1, "scalar", False), (1, "co", True),
                                 (4, "pco", True), (4, "co", False),
                                 (4, "scalar", True)):
            scale, bias = epilogue(form, pack, cout, device, gen)
            xp = pack_volume(x, pack).contiguous()
            got = conv3d_packed_s1(xp, k, scale, bias, pack=pack, relu=relu)
            want = conv3d_packed_s1_plain(xp, k, scale, bias, pack, relu)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            tol = CONV_RTOL * want.abs().max().item()
            assert e <= tol, (cin, cout, d, h, w, pack, form, relu, e, tol)
            err = max(err, e)
            del xp, got, want
        # the path's call: pack 1, unit scale, zero bias, no ReLU
        w_oi = k.permute(4, 3, 0, 1, 2).contiguous()
        x_cf = x.movedim(-1, 1)      # channels_last_3d storage, no copy
        ms = time_ms(lambda: conv3d_packed_s1(x, k, pack=1))
        plain = time_ms(lambda: conv3d_packed_s1_plain(x, k, pack=1), 3)
        lib = time_ms(lambda: F.conv3d(x_cf, w_oi, padding=1))
        vox = TRAIN_BATCH * d * h * w
        b_ms, b_by = bound_ms(2 * 27 * cin * cout * vox,
                              4 * (vox * (cin + cout) + k.numel()))
        print(f"K4 conv3d_packed_s1 {cin}->{cout} {TRAIN_BATCH}x{d}x{h}x{w} "
              f"(x{per_step}/step): {ms:.3f} ms, plain {plain:.3f}, "
              f"F.conv3d {lib:.3f}, bound {b_ms:.3f} ({b_by}), max_abs_err "
              f"{err:.3g}")
        rows.append((per_step, ms, plain, lib, b_ms, err))
        del x
    err = max(max(r[5] for r in rows), check_packed_conv_backward(device,
                                                                  gen))
    total = lambda i: sum(r[0] * r[i] for r in rows)
    return {"unit": "per train step (13 launches at the 4 shapes)",
            "max_abs_err": err, "ms": total(1), "plain_ms": total(2),
            "library_ms": total(3), "bound_ms": total(4),
            "bound_by": "operations"}


def check_packed_conv_backward(device, gen):
    """K4's gradients (the plain conv's VJP on cuDNN) against autograd of
    conv3d_packed_s1_plain: the path's call at its 32->32 shape, and pack 4
    with a [Co] scale, a [P*Co] bias and ReLU at the 1/2 shape."""
    from densematchingbenchmark_tpu_torch.ops.conv3d import pack_volume
    from densematchingbenchmark_tpu_torch.ops.cuda import (
        conv3d_packed_s1, conv3d_packed_s1_plain)
    worst = 0.0
    for cin, cout, (d, h, w), pack, relu in ((32, 32, (48, 64, 128), 1,
                                              False),
                                             (64, 64, (24, 32, 64), 4,
                                              True)):
        x = torch.randn((TRAIN_BATCH, d, h, w, cin), device=device,
                        generator=gen)
        xp = pack_volume(x, pack).contiguous().requires_grad_()
        k = (torch.randn((3, 3, 3, cin, cout), device=device, generator=gen)
             * (27 * cin) ** -0.5).requires_grad_()
        leaves, extra = [xp, k], {}
        if pack > 1:
            scale = (torch.rand(cout, device=device, generator=gen)
                     + 0.5).requires_grad_()
            bias = torch.randn(pack * cout, device=device,
                               generator=gen).requires_grad_()
            leaves += [scale, bias]
            extra = {"scale": scale, "bias": bias}
        ct = torch.randn(xp.shape[:-1] + (pack * cout,), device=device,
                         generator=gen)
        out = conv3d_packed_s1(xp, k, pack=pack, relu=relu, **extra)
        got = torch.autograd.grad(out, leaves, ct, retain_graph=True)
        # The ReLU passes the gradient where the kernel's output is
        # positive. The plain output differs from it by ~1e-5, which flips
        # that mask at the ~1e-5 of outputs nearest 0, so the plain side
        # takes the kernel's mask and runs without its own ReLU.
        plain_out = conv3d_packed_s1_plain(xp, k, pack=pack, **extra)
        want = torch.autograd.grad(plain_out, leaves,
                                   ct * (out > 0) if relu else ct,
                                   retain_graph=True)
        torch.cuda.synchronize()
        errs = []
        for name, g, wt in zip(("x", "kernel", "scale", "bias"), got, want):
            e = (g - wt).abs().max().item()
            tol = CONV_GRAD_RTOL * wt.abs().max().item()
            assert e <= tol, (cin, cout, pack, name, e, tol)
            errs.append(e)
            worst = max(worst, e)
        ms = time_ms(lambda: torch.autograd.grad(out, leaves, ct,
                                                 retain_graph=True))
        plain = time_ms(lambda: torch.autograd.grad(plain_out, leaves, ct,
                                                    retain_graph=True), 3)
        print(f"K4 backward {cin}->{cout} {TRAIN_BATCH}x{d}x{h}x{w} pack "
              f"{pack}: {ms:.3f} ms (cuDNN gradient convs), plain autograd "
              f"{plain:.3f}, max_abs_err {['%.3g' % e for e in errs]}")
        del x, xp, out, plain_out, got, want
    return worst


def check_soft_argmin_backward(device, gen):
    """The K2 backward kernel against autograd of soft_argmin_plain at the
    training cost volume, and the K2 forward's output there."""
    from densematchingbenchmark_tpu_torch.ops.cost_volume import (
        disp_sample_values)
    from densematchingbenchmark_tpu_torch.ops.cuda import (
        fused_soft_argmin, fused_soft_argmin_backward, soft_argmin_plain)
    from densematchingbenchmark_tpu_torch.ops.cuda.soft_argmin_kernel import (
        _forward)
    b, d, h, w = TRAIN_ARGMIN_SHAPE
    cost = (torch.randn(TRAIN_ARGMIN_SHAPE, device=device, generator=gen)
            * 3).requires_grad_()
    g = torch.randn((b, h, w, 1), device=device, generator=gen)
    err = 0.0
    for max_disp, start, dil, alpha in ((d, 0, 1, 1.0), (2 * d, -2, 2, 2.5)):
        vals = torch.as_tensor(disp_sample_values(max_disp, start, dil),
                               device=device)
        out = fused_soft_argmin(cost, max_disp, start, dil, alpha)
        assert out.grad_fn is not None
        plain_out = soft_argmin_plain(cost, vals, alpha)
        # the forward at the training shape too, with its batch index
        e = (out - plain_out).abs().max().item()
        assert e <= ARGMIN_ATOL, ("forward", max_disp, e)
        (got,) = torch.autograd.grad(out, cost, g)
        (want,) = torch.autograd.grad(plain_out, cost, g)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        tol = ARGMIN_GRAD_RTOL * want.abs().max().item()
        assert e <= tol, (max_disp, e, tol)
        err = max(err, e)
        del got, want, out, plain_out
    vals = torch.as_tensor(disp_sample_values(d), device=device)
    c = cost.detach()
    out, m, l = _forward(c, vals, 1.0)
    ms = time_ms(lambda: fused_soft_argmin_backward(c, vals, 1.0, out, m, l,
                                                    g))
    plain_out = soft_argmin_plain(cost, vals)
    plain = time_ms(lambda: torch.autograd.grad(plain_out, cost, g,
                                                retain_graph=True), 3)
    # per cost value: scale, subtract, exp, subtract, 3 multiplies; reads
    # the cost and writes its gradient once, plus the per-pixel terms
    b_ms, b_by = bound_ms(7 * c.numel(),
                          4 * (2 * c.numel() + 4 * b * h * w + d))
    print(f"K2 fused_soft_argmin_backward {list(TRAIN_ARGMIN_SHAPE)} "
          f"(x3/step): {ms:.3f} ms, plain (autograd of softmax + sum) "
          f"{plain:.3f}, bound {b_ms:.3f} ({b_by}), max_abs_err {err:.3g}")
    return {"unit": "per launch", "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "library_ms": None, "bound_ms": b_ms,
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


def train_phase():
    """train_matcher on PSMNet/scene_flow_f32 at full width, 256x512 batch
    3, for TRAIN_STEPS steps; returns the launch counts of the run."""
    from densematchingbenchmark_tpu_torch.configs import get_config
    from densematchingbenchmark_tpu_torch.data import (SyntheticStereoDataset,
                                                       transforms)
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    from densematchingbenchmark_tpu_torch.trainer import train_matcher
    from densematchingbenchmark_tpu_torch.trainer.loop import read_metrics
    from densematchingbenchmark_tpu_torch.utils.checkpoint import (
        CheckpointManager)
    cfg = get_config("PSMNet/scene_flow_f32")
    data = cfg["data"]
    assert data["batch_size_per_device"] == TRAIN_BATCH
    crop = data["train"]["input_shape"]
    # one epoch longer than the run, so the checkpoint lands mid-epoch
    ds = SyntheticStereoDataset(
        length=TRAIN_BATCH * (TRAIN_STEPS + 1), height=crop[0] + 32,
        width=crop[1] + 64, max_disp=cfg["model"]["max_disp"],
        transform=transforms.make_train_transform(crop, data["mean"],
                                                  data["std"]))
    with tempfile.TemporaryDirectory() as work:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        state = train_matcher(cfg, work, train_dataset=ds,
                              max_steps=TRAIN_STEPS, log_interval=1)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        records = read_metrics(work)
        _, meta = CheckpointManager(work).restore()
    n_params = sum(p.numel() for p in state.module.parameters())
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
    assert per_step == {"fused_conv3d": 0, "fused_soft_argmin": 3,
                        "fused_soft_argmin_backward": 3,
                        "fused_upsample_soft_argmin": 0,
                        "conv3d_packed_s1": 13}, counts
    losses = [r["train/loss"] for r in records]
    assert [r["step"] for r in records] == list(range(1, TRAIN_STEPS + 1))
    assert np.isfinite(losses).all(), losses
    assert meta == {"epoch": 0, "batch_in_epoch": TRAIN_STEPS}, meta
    step_ms = float(np.median([r["train/step_ms"] for r in records[1:]]))
    peak = max(r["train/peak_mem_gib"] for r in records)
    print(f"train: PSMNet/scene_flow_f32 {n_params / 1e6:.3f} M params, "
          f"{TRAIN_BATCH}x{crop[0]}x{crop[1]}, {TRAIN_STEPS} steps: losses "
          f"{[round(x, 4) for x in losses]}, grad_norm "
          f"{[round(r['train/grad_norm'], 3) for r in records]}; step "
          f"{step_ms:.2f} ms (median of steps 2-{TRAIN_STEPS}, host clock), "
          f"{TRAIN_BATCH / step_ms * 1e3:.2f} samples/s, peak {peak:.2f} "
          f"GiB; launches per step {per_step}; checkpoint resumes at {meta}")
    return counts


def small_batch(cfg, crop, gen_hw, max_disp, device):
    """One collated batch of SyntheticStereoDataset, on ``device``."""
    from densematchingbenchmark_tpu_torch.data import (DataLoader,
                                                       SyntheticStereoDataset,
                                                       transforms)
    data = cfg["data"]
    ds = SyntheticStereoDataset(
        length=8, height=gen_hw[0], width=gen_hw[1], max_disp=max_disp,
        transform=transforms.make_train_transform(crop, data["mean"],
                                                  data["std"]))
    loader = DataLoader(ds, data["batch_size_per_device"], seed=0)
    batch = next(iter(loader.epoch(0)))
    return {k: torch.from_numpy(batch[k]).to(device)
            for k in ("leftImage", "rightImage", "leftDisp")}


def grads_and_step(module, batch, cfg):
    """({name: gradient}, metrics, {name: parameter after one train step})
    of ``module`` on ``batch``; the gradients from a train-mode copy."""
    from densematchingbenchmark_tpu_torch.losses import (make_loss_evaluator,
                                                         total_loss)
    from densematchingbenchmark_tpu_torch.trainer import (TrainState,
                                                          build_optimizer,
                                                          make_train_step)
    ev = make_loss_evaluator(cfg["model"]["losses"])
    probe = copy.deepcopy(module).train()
    out = probe(batch["leftImage"], batch["rightImage"])
    loss = total_loss(ev(out["disps"], out["costs"], batch["leftDisp"]))
    names = [n for n, _ in probe.named_parameters()]
    grads = torch.autograd.grad(loss, list(probe.parameters()))
    opt, schedule = build_optimizer(cfg, module, 10)
    _, metrics = make_train_step(ev)(TrainState.create(module, opt, 1), batch)
    return ({n: g.cpu() for n, g in zip(names, grads)},
            {k: float(v) for k, v in metrics.items()},
            {n: p.detach().cpu() for n, p in module.named_parameters()},
            schedule(0))


def same_weights_phase():
    """One train step on the card and on the CPU (plain versions) from the
    same weights and batch."""
    from densematchingbenchmark_tpu_torch.configs import get_config
    from densematchingbenchmark_tpu_torch.models import build_model
    cfg = get_config("PSMNet/scene_flow_f32", **SMALL)
    cpu = build_model(cfg, torch.Generator().manual_seed(1))
    card = copy.deepcopy(cpu).cuda()
    batch = small_batch(cfg, (64, 128), (96, 192), 24, "cuda")
    g_card, m_card, p_card, lr0 = grads_and_step(card, batch, cfg)
    g_cpu, m_cpu, p_cpu, _ = grads_and_step(
        cpu, {k: v.cpu() for k, v in batch.items()}, cfg)
    loss_err = max(abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu)
    assert loss_err <= TRAIN_LOSS_RTOL, (m_card, m_cpu)
    worst_cos, worst_param = 1.0, 0.0
    for n, gc in g_cpu.items():
        ga = g_card[n]
        if gc.abs().max() < 1e-6:    # conv bias before batch-statistics BN
            continue
        cos = float((ga * gc).sum() / (ga.norm() * gc.norm()))
        assert cos > TRAIN_GRAD_COS, (n, cos)
        worst_cos = min(worst_cos, cos)
        # the first RMSprop update moves a parameter by lr * g /
        # sqrt(0.01 g^2 + eps): its slope through g = 0 is lr / sqrt(eps),
        # so the parameters differ by at most that times the gradients'
        # difference, plus float32 rounding
        tol = 2e-5 + lr0 / 1e-4 * (ga - gc).abs()
        d = (p_card[n] - p_cpu[n]).abs()
        assert (d <= tol).all(), n
        worst_param = max(worst_param, d.max().item())
    print(f"same weights, card vs CPU at {SMALL['model.max_disp']} disps, "
          f"2x64x128: metrics rel err {loss_err:.3g} (tolerance "
          f"{TRAIN_LOSS_RTOL}), worst gradient cosine {worst_cos:.6f} "
          f"(> {TRAIN_GRAD_COS}), updated params max diff {worst_param:.3g} "
          f"(within 2e-5 + lr/sqrt(eps) * |grad diff|)")


def overfit_phase():
    """24 train steps on one batch at a tiny size: the loss must fall below
    0.7x its first value and the batch's EPE must fall (the convergence
    criterion of the JAX package's CPU gauntlet)."""
    from densematchingbenchmark_tpu_torch.configs import get_config
    from densematchingbenchmark_tpu_torch.losses import make_loss_evaluator
    from densematchingbenchmark_tpu_torch.models import build_model
    from densematchingbenchmark_tpu_torch.trainer import (TrainState,
                                                          build_optimizer,
                                                          make_train_step)
    cfg = get_config("PSMNet/scene_flow_f32", **dict(
        SMALL, **{"optimizer.lr": 2e-3, "lr_schedule.warmup_iters": 0}))
    batch = small_batch(cfg, (64, 96), (96, 160), 12, "cuda")
    module = build_model(cfg, torch.Generator().manual_seed(0)).cuda()
    opt, _ = build_optimizer(cfg, module, 4)
    state = TrainState.create(module, opt, 1)
    gt = batch["leftDisp"]
    valid = (gt > 0) & (gt < cfg["model"]["max_disp"])

    def epe():
        module.eval()
        with torch.no_grad():
            disp = module(batch["leftImage"], batch["rightImage"])["disps"][0]
        return (disp - gt).abs()[valid].mean().item()

    step = make_train_step(make_loss_evaluator(cfg["model"]["losses"]))
    epe_init = epe()
    losses = []
    for _ in range(OVERFIT_STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    epe_final = epe()
    print(f"overfit: {OVERFIT_STEPS} steps on one 2x64x96 batch, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({losses[-1] / losses[0]:.3f}x, must be < 0.7x), EPE "
          f"{epe_init:.3f} -> {epe_final:.3f} px")
    assert losses[-1] < 0.7 * losses[0], losses
    assert epe_final < epe_init, (epe_init, epe_final)


def device_profile(label, fn, reps=2, top=14, convs=0):
    """Device time of one call of ``fn`` by kernel name (torch.profiler),
    after one call outside the profile; with ``convs``, also the ``convs``
    convolution ops (forward or backward, by input shapes) that take the
    most device time, their kernels included."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=bool(convs)) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    # kernels only: device time of events that are not CPU-side ops
    rows = [(e.key, e.self_device_time_total / 1e3 / reps, e.count // reps)
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.device_type.name == "CUDA"]
    busy = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    print(f"profile {label}: wall {wall:.2f} ms per call under the "
          f"profiler, device busy {busy:.2f} ms ({100 * busy / wall:.1f}%), "
          f"{launches} kernel launches of {len(rows)} names")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"  {ms:8.3f} ms {count:4d}x  {key[:90]}")
    if convs:
        ops = [e for e in prof.key_averages(group_by_input_shape=True)
               if e.key in ("aten::convolution", "aten::convolution_backward")]
        for e in sorted(ops, key=lambda e: -e.device_time_total)[:convs]:
            print(f"  {e.device_time_total / 1e3 / reps:8.3f} ms "
                  f"{e.count // reps:4d}x  {e.key} {e.input_shapes[:2]}")


def profile_phase(models):
    """The forward of each eval mode, and one training step, by kernel."""
    from densematchingbenchmark_tpu_torch.configs import get_config
    from densematchingbenchmark_tpu_torch.losses import make_loss_evaluator
    from densematchingbenchmark_tpu_torch.models import build_model
    from densematchingbenchmark_tpu_torch.trainer import (TrainState,
                                                          build_optimizer,
                                                          make_train_step)
    x = torch.randn((1, *PADDED, 3), device="cuda")
    for model in models:
        fused = model.module.fused_upsample_argmin
        device_profile(f"forward fused_upsample_argmin={fused}",
                       lambda: model.forward(x, x))
    cfg = get_config("PSMNet/scene_flow_f32")
    crop = cfg["data"]["train"]["input_shape"]
    batch = small_batch(cfg, crop, (crop[0] + 32, crop[1] + 64), 192, "cuda")
    module = build_model(cfg, torch.Generator().manual_seed(0)).cuda()
    state = TrainState.create(module, build_optimizer(cfg, module, 10)[0], 1)
    step = make_train_step(make_loss_evaluator(cfg["model"]["losses"]))
    label = f"train step {TRAIN_BATCH}x{crop[0]}x{crop[1]}"
    device_profile(label, lambda: step(state, batch), top=24, convs=12)
    # the same step with cuDNN's algorithms chosen by timing each shape
    # instead of by its heuristics, to see what the library's choice costs
    torch.backends.cudnn.benchmark = True
    device_profile(f"{label}, cudnn.benchmark", lambda: step(state, batch),
                   top=8)
    torch.backends.cudnn.benchmark = False


def main():
    device_phase()
    build_phase()
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    gen = torch.Generator(device="cuda").manual_seed(0)
    stats = {"fused_conv3d": check_conv("cuda", gen),
             "fused_soft_argmin": check_soft_argmin("cuda", gen),
             "fused_upsample_soft_argmin": check_upsample("cuda", gen),
             "conv3d_packed_s1": check_packed_conv("cuda", gen),
             "fused_soft_argmin_backward": check_soft_argmin_backward(
                 "cuda", gen)}
    torch.cuda.empty_cache()
    launches, models = slice_phase()
    if "--profile" in sys.argv[1:]:
        profile_phase(models)
    del models
    torch.cuda.empty_cache()
    for name, n in train_phase().items():
        launches[name] += n
    same_weights_phase()
    overfit_phase()
    rows = []
    for k in kernels.KERNELS:
        name = k.__name__
        route, source, replaces = SOURCES[name]
        assert launches[name] > 0, f"{name} never launched on a main path"
        rows.append({"name": name, "route": route, "source": source,
                     "replaces": replaces, "launches": launches[name],
                     **stats[name]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
