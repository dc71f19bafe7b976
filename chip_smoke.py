#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port (densematchingbenchmark_tpu_torch) through its own entry
points and holds every hand-written kernel of its paths against its plain
PyTorch version on the card. Phases, each fatal on failure:

  1. device: needs CUDA; prints the card's name and power limit
     (nvidia-smi) and turns TF32 off for matmuls and cuDNN convolutions.
  2. build: compiles the CUDA C++ kernels from csrc/ (one nvcc per source,
     all at once) and prints the build seconds and ptxas's report; asserts
     HGMMA (wgmma) instructions in the SASS of the bfloat16 K4 and K5
     kernels and none in the CUDA-core kernels (K1, float32 K4 and K5);
     prints the float32 K5 kernel's registers and blocks per SM as built,
     and the float32 block's (K1, K4) registers for each Cout tile.
  3. kernels: each kernel against its plain version at the shapes of its
     path (K1, K2, K3 at the 384x1248 inference shapes; K4 forward and
     backward and the K2 backward at the 256x512 batch-3 training shapes),
     with its time, its plain version's time, a one-call library yardstick
     where there is one, and its bound (K3's counts its exponentials at the
     special-function units' rate beside its FMAs, and says which binds).
     K1 and K4 (the float32 block) print each shape's launch plan and are
     also held against a float64 reference at one ragged shape (as K5,
     below). K1, K4 and K2's forward also give their time over 20 calls in
     a row (device time, the host's work overlapped), K2 at both of its
     shapes, and K2's compiled PTX must hold no barrier (bar.sync): its
     reduction over D stays inside each thread.
  3b. packed: K5 (conv3d_packed_s1_v2) and K4 against
     conv3d_packed_s1_plain at the three cases of the packed-conv
     microbench (pack 4), in float32 and bfloat16 (the tensor-core route),
     with every epilogue form and ReLU on and off, and K4 in bfloat16 at
     pack 1 at the training trunk shapes; K5's float32 times beside its
     bound and cuDNN's F.conv3d, the plain version's time in both dtypes;
     K5's float32 result against a float64 reference (the plain version on
     float64 operands): its error at most 2x the float32 plain version's
     plus CONV_RTOL of the reference's largest value (check_f64).
  3d. no synchronising copy: torch.cuda.set_sync_debug_mode("error")
     around a second call (the first fills the caches) of K3, the K2
     forward and backward, upsample_3d, K5 in float32, and the eval forward
     of a tiny PSMNet in each eval mode on inputs already on the card.
  3c. microbench: tools.microbench_packed.run on its three cases in each
     dtype (10 chained iterations), with each run's launch counts asserted
     (K4 and K5 60 each, all of them bfloat16 in the bfloat16 run, the
     others none), its table, its totals beside the bounds (float32 on the
     CUDA cores, bfloat16 at the tensor-core rate) and, per case, the
     bfloat16 kernels' ratio to cuDNN's bf16 conv and share of the bound.
  4. slice: init_model("PSMNet/scene_flow_f32", seed=0) on cuda (random
     weights from the seed, full width) and inference_stereo over three
     random 375x1242 pairs padded to 384x1248, in both eval modes
     (model.eval.fused_upsample_argmin False: K1 + K2; True: K1 + K3),
     with the launch counts of each mode asserted, the two modes compared
     with each other and, on a small pair, with the same weights run
     through the plain versions on the CPU.
  4b. eval: K1 and K3 against their plain versions at the batch-4 eval
     shapes; a KITTI-2015-layout dataset written with the port's own
     writers (six SyntheticStereoDataset pairs at KITTI frame sizes, RGB
     PNGs of every row filter, uint16 disparity PNGs of both views, an
     annotation JSON) through tools/test.main on PSMNet/kitti_2015_f32 at
     full width in both eval modes, padded to 384x1248, at the config's
     eval batch 4 (two batches: K1 26 launches, K2 or K3 6, asserted);
     each mode's metrics against batch-1 inference_stereo on the same
     files with per-sample metrics in float64 numpy (EPE within
     EVAL_EPE_ATOL px, each n-px share within EVAL_PX_ATOL points), and the
     two modes against each other; the eval loop's per-batch work under
     the sync guard (the final fetch outside it); eval ms per sample at
     batch 4 and 1, samples/s and peak memory; a checkpoint restored
     through init_model(checkpoint_dir=...) gives the saved module's
     disparities exactly. Then the PNG decoder's host time on one 375x1242
     RGB frame per row filter, and tools/bench.py's JSON line; each of
     these lines carries the card's name and power limit.
  5. train: trainer.loop.train_matcher on PSMNet/scene_flow_f32 at full
     width, its own 256x512 crop and batch 3 of SyntheticStereoDataset, for
     5 steps, then its evaluation of a two-sample synthetic eval set at
     384x1248, with the launches asserted (per step K4 13, K2 3 forward and
     3 backward, K1 and K3 none; the eval batch K1 13 and K2 3), finite
     losses, 'eval/' metrics in metrics.log.json, the step time,
     samples/s, peak memory and the checkpoint's resume position.
  6. same weights: one train step at a small size on the card and on the
     CPU (the plain versions) from the same weights and batch: loss,
     per-parameter gradient cosine and updated parameters.
  7. overfit: 24 train steps on one batch at a tiny size (max_disp 32,
     crop 64x96, lr 2e-3, no warmup); the loss must fall below 0.7x its
     first value and the batch's EPE must fall.

Prints a JSON line of per-kernel numbers before the last line (K4's and
K5's bfloat16 routes in rows of their own, ``*_bf16``), and as the last
line {"ok": true, "device": {...}}. Imports nothing of JAX.

    python3 chip_smoke.py --profile

adds, before the JSON lines, the device time by kernel name
(torch.profiler) and the device's busy share of one forward in each eval
mode, of one evaluate over the eval phase's six pairs in each mode, and
of one training step at 256x512 batch 3.
"""

import contextlib
import copy
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet): float32 on the CUDA cores, dense
# bfloat16 on the tensor cores, HBM3; and the special-function units'
# exponentials (MUFU.EX2), 16 a clock on each SM (at the SM clock that
# nvidia-smi reports as clocks.max.sm).
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
EX2_PER_CLOCK_PER_SM = 16

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
# the tiny configuration of the no-synchronisation guard's PSMNet forward
SYNC_TINY = {"model.max_disp": 64,
             "model.cost_processor.cost_computation.max_disp": 16,
             "model.cost_processor.cost_aggregator.max_disp": 64,
             "model.disp_predictor.max_disp": 64}
# the packed-conv microbench: pack and chained iterations per row
MICRO_PACK, MICRO_ITERS = 4, 10
# Evaluation: PSMNet/kitti_2015_f32 through tools/test.py over six pairs of
# KITTI frame sizes, padded to 384x1248, at the config's eval batch 4: two
# batches (4 + 2), each 13 K1 launches and 3 of K2 (plain) or K3 (fused).
EVAL_CONFIG = "PSMNet/kitti_2015_f32"
EVAL_SIZES = ((375, 1242),) * 3 + ((370, 1224), (376, 1241), (374, 1238))
EVAL_BATCH, EVAL_BATCHES = 4, 2
# the train phase's per-epoch eval set: two synthetic samples at 384x1248,
# one batch at scene_flow's eval batch 4
TRAIN_EVAL = 2

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
BF16_STEP = 2.0 ** -7  # of max|plain|: in bfloat16 the kernel and the plain
                       # version each round their float32 result once
EVAL_EPE_ATOL = 1e-3   # px: mean EPE of the batched eval vs the batch-1
                       # reference (float32 sums in another order per batch)
EVAL_PX_ATOL = 0.01    # percentage points of an n-px share: 46 of the
                       # 465,750 pixels of a 375x1242 frame crossing a
                       # threshold

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
    "conv3d_packed_s1_v2": ("cuda", "densematchingbenchmark_tpu_torch/csrc/packed_conv3d_v2_kernel.cu",
                            "densematchingbenchmark_tpu/ops/pallas/packed_conv3d_kernel.py:382"),
}
# the bfloat16 routes of K4 and K5 (the wgmma block), rows of their own
BF16_SOURCES = {
    "conv3d_packed_s1": ("conv3d_packed_s1_bf16", "K4"),
    "conv3d_packed_s1_v2": ("conv3d_packed_s1_v2_bf16", "K5"),
}
WGMMA_SOURCE = "densematchingbenchmark_tpu_torch/csrc/conv3d_wgmma.cuh"


def bound_ms(flops, nbytes, peak_flops=PEAK_F32_FLOPS):
    """Least time for the work on the card, and what sets it."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def sm_clock_hz():
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]
    return float(mhz) * 1e6


def chained_ms(fn, n=20):
    """Device time of one call of ``fn`` over ``n`` calls in a row, after
    one warm-up call (CUDA events around the run)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


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


def hgmma_counts(library):
    """{kernel function: HGMMA instructions} in the library's SASS
    (cuobjdump -sass)."""
    import shutil
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


def build_phase():
    from densematchingbenchmark_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(logs) or 'nothing (already built)'}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    # the bfloat16 K4 and K5 kernels run on the tensor cores (HGMMA is
    # wgmma's SASS); the CUDA-core kernels, K1 among them, have none
    for name in ("conv3d_kernel", "packed_conv3d_kernel",
                 "packed_conv3d_v2_kernel"):
        counts = hgmma_counts(_build.library_path(name))
        wgmma = {f: n for f, n in counts.items() if "conv3d_wgmma" in f}
        others = {f: n for f, n in counts.items() if f not in wgmma}
        assert all(n == 0 for n in others.values()), (name, others)
        if name == "conv3d_kernel":
            assert not wgmma, (name, wgmma)
        else:
            assert wgmma and all(n > 0 for n in wgmma.values()), (name,
                                                                  counts)
        print(f"  {name}: HGMMA in {len(wgmma)} bf16 kernels "
              f"({sorted(wgmma.values())}), none in its {len(others)} "
              "CUDA-core kernels")
    from densematchingbenchmark_tpu_torch.ops.cuda import packed_conv3d_kernel
    res = packed_conv3d_kernel.library(
        "conv3d_packed_s1_v2").packed_conv3d_v2_f32_residency()
    assert res > 0, f"K5 float32 residency: CUDA error {-res}"
    print(f"  K5 float32 kernel: {res // 1000} registers a thread, "
          f"{res % 1000} blocks of 256 threads an SM")
    from densematchingbenchmark_tpu_torch.ops.cuda import conv3d_kernel
    for name, lib in (("K1", _build.load("conv3d_kernel",
                                         conv3d_kernel._SIGNATURES)),
                      ("K4", packed_conv3d_kernel.library(
                          "conv3d_packed_s1"))):
        fn = getattr(lib, "conv3d_bn_act_f32_regs" if name == "K1"
                     else "packed_conv3d_f32_regs")
        regs = {cob: fn(cob) for cob in (32, 64)}
        assert all(r > 0 for r in regs.values()), (name, regs)
        print(f"  {name} float32 block: registers a thread by Cout tile "
              f"{regs}")


def f32_plan_text(prefix, b, r, pack, h, w, ci, co):
    """The float32 block's launch plan of a call shape, as its wrapper
    made it (kept per shape)."""
    from densematchingbenchmark_tpu_torch.ops.cuda import _build
    from densematchingbenchmark_tpu_torch.ops.cuda import packed_conv3d_kernel as pk
    from densematchingbenchmark_tpu_torch.ops.cuda.conv3d_kernel import (
        _SIGNATURES)
    lib = (_build.load("conv3d_kernel", _SIGNATURES) if prefix == "K1"
           else pk.library("conv3d_packed_s1"))
    p = pk.f32_plan(lib, "conv3d_bn_act" if prefix == "K1"
                    else "packed_conv3d", torch.cuda.current_device(), b, r,
                    pack, h, w, ci, co)
    return (f"plan cob {p['cob']} th {p['th']} stages {p['stages']} "
            f"threads {p['threads']} blocks {p['blocks']}")


def check_conv(device, gen):
    """K1 against conv3d_plain at each trunk shape, relu both ways, and
    against a float64 reference at a ragged shape."""
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
        chain = chained_ms(lambda: fused_conv3d(x, k, scale, bias, relu=True))
        plain = time_ms(lambda: conv3d_plain(x, k, scale, bias, True), 3)
        lib = time_ms(lambda: torch.relu(
            F.conv3d(x_cf, w_oi, padding=1) * s5 + b5))
        vox = d * h * w
        b_ms, b_by = bound_ms(2 * 27 * cin * cout * vox,
                              4 * (vox * (cin + cout) + k.numel() + 2 * cout))
        print(f"K1 fused_conv3d {cin}->{cout} {d}x{h}x{w} (x{per_fwd}/fwd): "
              f"{ms:.3f} ms, chained {chain:.3f}, plain {plain:.3f}, F.conv3d "
              f"{lib:.3f}, bound {b_ms:.3f} ({b_by}), max_abs_err {err:.3g}; "
              + f32_plan_text("K1", 1, d, 1, h, w, cin, cout))
        rows.append((per_fwd, ms, plain, lib, b_ms, err, chain))
        del x, got, want
    # a ragged shape (H, W, Cout not multiples of a tile) against float64
    x = torch.randn((1, 7, 21, 78, 64), device=device, generator=gen)
    k = torch.randn((3, 3, 3, 64, 36), device=device, generator=gen) * 0.03
    scale = torch.rand(36, device=device, generator=gen) + 0.5
    bias = torch.randn(36, device=device, generator=gen)
    print("K1 fused_conv3d 64->36 7x21x78: " + check_f64(
        "K1", fused_conv3d, conv3d_plain, (x, k, scale, bias),
        {"relu": True}))
    total = lambda i: sum(r[0] * r[i] for r in rows)
    return {"unit": "per forward (13 launches at the 4 shapes)",
            "max_abs_err": max(r[5] for r in rows), "ms": total(1),
            "chained_ms": total(6), "plain_ms": total(2),
            "library_ms": total(3), "bound_ms": total(4),
            "bound_by": "operations"}


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
    chain = chained_ms(lambda: fused_soft_argmin(cost, d))
    plain = time_ms(lambda: soft_argmin_plain(cost, vals), 3)
    # per cost value: scale, max, subtract, exp, sum, multiply-add
    b_ms, b_by = bound_ms(6 * cost.numel(),
                          4 * (cost.numel() + d + b * h * w))
    # the training shape's forward (the path's call under autograd stores
    # the per-pixel statistics besides)
    train = torch.randn(TRAIN_ARGMIN_SHAPE, device=device, generator=gen)
    t_ms = time_ms(lambda: fused_soft_argmin(train, d))
    t_chain = chained_ms(lambda: fused_soft_argmin(train, d))
    t_bound = bound_ms(6 * train.numel(), 4 * (train.numel() + d
                                                + train[:, 0].numel()))[0]
    print(f"K2 fused_soft_argmin {list(ARGMIN_SHAPE)} (x3/fwd): {ms:.3f} ms, "
          f"chained {chain:.3f} ms a launch, plain {plain:.3f}, bound "
          f"{b_ms:.3f} ({b_by}), max_abs_err {err:.3g}; "
          f"{list(TRAIN_ARGMIN_SHAPE)}: {t_ms:.3f} ms, chained {t_chain:.3f}, "
          f"bound {t_bound:.3f}; " + soft_argmin_barriers(cost, vals))
    del train
    return {"unit": "per launch", "max_abs_err": err, "ms": ms,
            "chained_ms": chain, "plain_ms": plain, "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by}


def soft_argmin_barriers(cost, vals):
    """Compile K2's forward for ``cost`` as its wrapper launches it (one
    launch of the Triton kernel, outside the wrapper and its count) and
    assert that its PTX holds no barrier: the reduction over D stays in
    each thread's registers. Returns the line's text."""
    from densematchingbenchmark_tpu_torch.ops.cuda import (
        soft_argmin_kernel as sak)
    b, d, h, w = cost.shape
    triton, kernel, _ = sak._triton_kernels()
    out = torch.empty((b, h, w, 1), device=cost.device)
    block_w = 128 * sak.FWD_WARPS
    compiled = kernel[(triton.cdiv(w, block_w), h, b)](
        cost, vals, out, out, out, d, h, w, 1.0, STATS=False,
        DEPTH=sak.FWD_DEPTH, BLOCK_W=block_w, num_warps=sak.FWD_WARPS,
        num_stages=1)
    ptx = compiled.asm["ptx"]
    counts = {k: ptx.count(k) for k in ("bar.sync", "bar.arrive",
                                        "barrier.sync", "ld.shared",
                                        "st.shared")}
    assert not any(counts.values()), counts
    return f"PTX of the forward: {counts}"


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
    chain = chained_ms(lambda: fused_upsample_soft_argmin(low, out_d, out_h,
                                                          out_w))
    # per output pixel: 3 lerps (3 flops each) for each of the D' source
    # depths, then per upsampled depth a lerp, the scale, subtract, exp,
    # sum and multiply-add (8) on the FMA pipes; and one exponential per
    # upsampled cost on the special-function units
    pixels = b * out_h * out_w
    b_ms, b_by = bound_ms(pixels * (9 * d_in + 8 * out_d),
                          4 * (low.numel() + pixels + 4 * out_d
                               + 3 * (out_h + out_w)))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ex2_ms = pixels * out_d / (EX2_PER_CLOCK_PER_SM * sms
                               * sm_clock_hz()) * 1e3
    binds = "exponentials (SFU)" if ex2_ms > b_ms else f"FMAs ({b_by})"
    if ex2_ms > b_ms:
        b_ms, b_by = ex2_ms, "operations"
    print(f"K3 fused_upsample_soft_argmin {list(UPSAMPLE_LOW)} -> "
          f"{list(UPSAMPLE_OUT)} (x3/fwd): {ms:.3f} ms, chained "
          f"{chain:.3f} ms a launch, plain {plain:.3f}, interpolate+softmax "
          f"{lib:.3f}, bound {b_ms:.3f}: exponentials {ex2_ms:.4f} ms at "
          f"{EX2_PER_CLOCK_PER_SM}/clock/SM on {sms} SMs, bound by {binds}, "
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
        chain = chained_ms(lambda: conv3d_packed_s1(x, k, pack=1))
        plain = time_ms(lambda: conv3d_packed_s1_plain(x, k, pack=1), 3)
        lib = time_ms(lambda: F.conv3d(x_cf, w_oi, padding=1))
        vox = TRAIN_BATCH * d * h * w
        b_ms, b_by = bound_ms(2 * 27 * cin * cout * vox,
                              4 * (vox * (cin + cout) + k.numel()))
        print(f"K4 conv3d_packed_s1 {cin}->{cout} {TRAIN_BATCH}x{d}x{h}x{w} "
              f"(x{per_step}/step): {ms:.3f} ms, chained {chain:.3f}, plain "
              f"{plain:.3f}, F.conv3d {lib:.3f}, bound {b_ms:.3f} ({b_by}), "
              f"max_abs_err {err:.3g}; " + f32_plan_text(
                  "K4", TRAIN_BATCH, d, 1, h, w, cin, cout))
        rows.append((per_step, ms, plain, lib, b_ms, err, chain))
        del x
    # a ragged shape at pack 4 (a [P*Co] epilogue, Cout 68: two Cout tiles)
    # against float64
    xp = torch.randn((2, 5, 13, 70, 4 * 12), device=device, generator=gen)
    k = torch.randn((3, 3, 3, 12, 68), device=device, generator=gen) * 0.1
    scale, bias = epilogue("pco", 4, 68, device, gen)
    print("K4 conv3d_packed_s1 12->68 2x20x13x70 pack 4: " + check_f64(
        "K4", conv3d_packed_s1, conv3d_packed_s1_plain, (xp, k, scale, bias),
        {"pack": 4, "relu": True}))
    err = max(max(r[5] for r in rows), check_packed_conv_backward(device,
                                                                  gen))
    total = lambda i: sum(r[0] * r[i] for r in rows)
    return {"unit": "per train step (13 launches at the 4 shapes)",
            "max_abs_err": err, "ms": total(1), "chained_ms": total(6),
            "plain_ms": total(2), "library_ms": total(3),
            "bound_ms": total(4), "bound_by": "operations"}


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


def packed_bound(shape, cin, cout, dtype):
    """bound_ms of the microbench's call (pack MICRO_PACK, unit scale, no
    ReLU): the true MACs at the dtype's peak; x and the output in the dtype,
    read and written once, the kernel once, the float32 epilogue terms."""
    vox = int(np.prod(shape))
    size = torch.finfo(dtype).bits // 8
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    return bound_ms(2 * 27 * cin * cout * vox,
                    size * (vox * (cin + cout) + 27 * cin * cout)
                    + 4 * 2 * MICRO_PACK * cout, peak)


def check_f64(label, kernel_fn, plain_fn, args, kwargs):
    """``kernel_fn(*args, **kwargs)`` on float32 operands against a float64
    reference, ``plain_fn`` on the same operands in float64: its error must
    be at most twice the float32 plain version's plus CONV_RTOL of the
    reference's largest value. Returns the line's text."""
    wide = [a.double() if torch.is_tensor(a) else a for a in args]
    ref = plain_fn(*wide, **kwargs)
    got = kernel_fn(*args, **kwargs)
    plain = plain_fn(*args, **kwargs)
    torch.cuda.synchronize()
    e_got = (got.double() - ref).abs().max().item()
    e_plain = (plain.double() - ref).abs().max().item()
    tol = 2 * e_plain + CONV_RTOL * ref.abs().max().item()
    assert e_got <= tol, ("float64", label, e_got, e_plain, tol)
    del ref, got, plain
    return (f"vs float64: {label} {e_got:.3g}, float32 plain {e_plain:.3g} "
            f"(tolerance {tol:.3g})")


def check_packed_v2(device, gen):
    """K5 and K4 against conv3d_packed_s1_plain at the microbench's cases
    (pack 4), in both dtypes, with every epilogue form and ReLU both ways,
    and K4 in bfloat16 at pack 1 at the training trunk shapes (where a bf16
    PSMNet would call it); K5's float32 times of the microbench's call
    (unit scale, no ReLU) and the plain version's bfloat16 time. Returns
    K5's float32 row over the three cases and, for the bfloat16 rows, each
    kernel's max_abs_err and the plain version's ms per case set; K4's
    times and the bfloat16 kernel times are the microbench phase's."""
    from densematchingbenchmark_tpu_torch.ops.conv3d import pack_volume
    from densematchingbenchmark_tpu_torch.ops.cuda import (
        conv3d_packed_s1, conv3d_packed_s1_plain, conv3d_packed_s1_v2)
    from densematchingbenchmark_tpu_torch.tools.microbench_packed import CASES
    pack = MICRO_PACK
    rows = []
    bf16 = {"K5": 0.0, "K4": 0.0, "plain_ms": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        step = BF16_STEP if dtype == torch.bfloat16 else 0.0
        dt = str(dtype).replace("torch.", "")
        for name, (b, d, h, w), cin, cout in CASES:
            x = torch.randn((b, d, h, w, cin), device=device,
                            generator=gen).to(dtype)
            k = (torch.randn((3, 3, 3, cin, cout), device=device,
                             generator=gen) * (27 * cin) ** -0.5).to(dtype)
            xp = pack_volume(x, pack).contiguous()
            err = {"K5": 0.0, "K4": 0.0}
            for form in ("scalar", "co", "pco"):
                for relu in (True, False):
                    scale, bias = epilogue(form, pack, cout, device, gen)
                    want = conv3d_packed_s1_plain(xp, k, scale, bias, pack,
                                                  relu)
                    tol = (CONV_RTOL + step) * want.abs().max().item()
                    for label, fn in (("K5", conv3d_packed_s1_v2),
                                      ("K4", conv3d_packed_s1)):
                        got = fn(xp, k, scale, bias, pack=pack, relu=relu)
                        torch.cuda.synchronize()
                        assert got.dtype == dtype, (label, got.dtype)
                        e = (got.float() - want.float()).abs().max().item()
                        assert e <= tol, (label, name, dtype, form, relu, e,
                                          tol)
                        err[label] = max(err[label], e)
                    del want
            line = (f"K5 conv3d_packed_s1_v2 {name} {b}x{d}x{h}x{w} pack "
                    f"{pack} {dt}: max_abs_err K5 {err['K5']:.3g} K4 "
                    f"{err['K4']:.3g}")
            plain = time_ms(lambda: conv3d_packed_s1_plain(xp, k, pack=pack),
                            3)
            if dtype == torch.float32:
                line += "; " + check_f64(
                    "K5", conv3d_packed_s1_v2, conv3d_packed_s1_plain,
                    (xp, k), {"pack": pack})
                w_oi = k.permute(4, 3, 0, 1, 2).contiguous(
                    memory_format=torch.channels_last_3d)
                x_cf = x.movedim(-1, 1)  # channels_last_3d storage, no copy
                ms = time_ms(lambda: conv3d_packed_s1_v2(xp, k, pack=pack))
                lib = time_ms(lambda: F.conv3d(x_cf, w_oi, padding=1))
                b_ms, b_by = packed_bound((b, d, h, w), cin, cout, dtype)
                line += (f"; {ms:.3f} ms, plain {plain:.3f}, F.conv3d "
                         f"{lib:.3f}, bound {b_ms:.3f} ({b_by})")
                rows.append((ms, plain, lib, b_ms, err["K5"], b_by))
                del x_cf
            else:
                line += f"; plain {plain:.3f} ms"
                bf16["plain_ms"] += plain
                for label in ("K4", "K5"):
                    bf16[label] = max(bf16[label], err[label])
            print(line)
            del x, k, xp
    # K4 in bfloat16 at pack 1 at the training trunk shapes, batch 3
    for cin, cout, (d, h, w), _ in TRAIN_CONV_SHAPES:
        x = torch.randn((TRAIN_BATCH, d, h, w, cin), device=device,
                        generator=gen).bfloat16()
        k = (torch.randn((3, 3, 3, cin, cout), device=device, generator=gen)
             * (27 * cin) ** -0.5).bfloat16()
        err = 0.0
        for form, relu in (("scalar", False), ("co", True), ("co", False)):
            scale, bias = epilogue(form, 1, cout, device, gen)
            want = conv3d_packed_s1_plain(x, k, scale, bias, 1, relu).float()
            got = conv3d_packed_s1(x, k, scale, bias, pack=1, relu=relu)
            torch.cuda.synchronize()
            e = (got.float() - want).abs().max().item()
            tol = (CONV_RTOL + BF16_STEP) * want.abs().max().item()
            assert e <= tol, (cin, cout, d, h, w, form, relu, e, tol)
            err = max(err, e)
        bf16["K4"] = max(bf16["K4"], err)
        print(f"K4 conv3d_packed_s1 bfloat16 {cin}->{cout} "
              f"{TRAIN_BATCH}x{d}x{h}x{w} pack 1: max_abs_err {err:.3g}")
        del x, k, got, want
    total = lambda i: sum(r[i] for r in rows)
    return {"unit": "per microbench case set (3 cases, pack 4, float32)",
            "max_abs_err": max(r[4] for r in rows), "ms": total(0),
            "plain_ms": total(1), "library_ms": total(2),
            "bound_ms": total(3),
            "bound_by": max(rows, key=lambda r: r[3])[5]}, bf16


def guarded(label, fn):
    """Call ``fn`` once to build its kernels and fill its caches, then
    again with torch.cuda.set_sync_debug_mode("error"), under which a
    synchronising call (a copy from pageable host memory, a read of a
    device value) raises."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"  no synchronising call: {label}")


def sync_guard_phase(gen):
    """The kernels and ops of the regression path and K5 in float32, and a
    tiny PSMNet's eval forward in both modes, issue no synchronising call
    once their caches are filled."""
    from densematchingbenchmark_tpu_torch.apis import init_model
    from densematchingbenchmark_tpu_torch.ops.conv3d import pack_volume
    from densematchingbenchmark_tpu_torch.ops.cuda import (
        conv3d_packed_s1_v2, fused_soft_argmin, fused_upsample_soft_argmin)
    from densematchingbenchmark_tpu_torch.ops.interpolate import upsample_3d
    out_d, out_h, out_w = UPSAMPLE_OUT
    low = torch.randn(UPSAMPLE_LOW, device="cuda", generator=gen)
    guarded("K3 fused_upsample_soft_argmin",
            lambda: fused_upsample_soft_argmin(low, out_d, out_h, out_w))
    guarded("upsample_3d", lambda: upsample_3d(low, out_d, out_h, out_w))
    b, d, h, w = TRAIN_ARGMIN_SHAPE
    cost = torch.randn((1, d, h, w), device="cuda",
                       generator=gen).requires_grad_()
    g = torch.randn((1, h, w, 1), device="cuda", generator=gen)
    guarded("K2 fused_soft_argmin forward and backward",
            lambda: torch.autograd.grad(fused_soft_argmin(cost, d), cost, g))
    x = torch.randn((1, 16, 48, 156, 32), device="cuda", generator=gen)
    k = torch.randn((3, 3, 3, 32, 32), device="cuda", generator=gen) * 0.06
    scale = torch.rand(32, device="cuda", generator=gen) + 0.5
    xp = pack_volume(x, MICRO_PACK).contiguous()
    guarded("K5 conv3d_packed_s1_v2 float32",
            lambda: (conv3d_packed_s1_v2(xp, k, pack=MICRO_PACK),
                     conv3d_packed_s1_v2(xp, k, scale, 0.5, pack=MICRO_PACK,
                                         relu=True)))
    image = torch.randn((1, 64, 128, 3), device="cuda", generator=gen)
    for fused in (False, True):
        model = init_model("PSMNet/scene_flow_f32", device="cuda", seed=0,
                           **dict(SYNC_TINY, **{
                               "model.eval.fused_upsample_argmin": fused}))
        guarded(f"PSMNet eval forward, fused_upsample_argmin={fused}",
                lambda: model.forward(image, image))


def microbench_phase():
    """The port's packed-conv microbench on its three cases in each dtype,
    with the launch counts of each dtype's run asserted. Returns the counts
    of both runs, their bfloat16 part, and each bfloat16 route's ms per
    case set beside cuDNN's bf16 unpacked conv and the bound."""
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    from densematchingbenchmark_tpu_torch.tools import microbench_packed
    cases = microbench_packed.CASES
    # K4 and K5 each: the cases x 2 chains (warm-up and timed)
    per_kernel = len(cases) * 2 * MICRO_ITERS
    counts = {name: 0 for name in kernels.launch_counts()}
    bf16_counts = {name: 0 for name in kernels.bf16_launch_counts()}
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        kernels.reset_launch_counts()
        rows += microbench_packed.run(dtype=dtype, pack=MICRO_PACK,
                                      iters=MICRO_ITERS, device="cuda")
        torch.cuda.synchronize()
        got, got_bf16 = kernels.launch_counts(), kernels.bf16_launch_counts()
        want = {name: 0 for name in got}
        want["conv3d_packed_s1"] = want["conv3d_packed_s1_v2"] = per_kernel
        n_bf16 = per_kernel if dtype == torch.bfloat16 else 0
        assert got == want, (dtype, got, want)
        assert got_bf16 == {name: n_bf16 for name in got_bf16}, (dtype,
                                                                 got_bf16)
        print(f"microbench_packed {dtype}: pack {MICRO_PACK}, {MICRO_ITERS} "
              f"chained iterations per row; launches {got}, bf16 {got_bf16}")
        for name in counts:
            counts[name] += got[name]
        for name in bf16_counts:
            bf16_counts[name] += got_bf16[name]
    for r in rows:
        print(f"  {r['dtype']:<8} {microbench_packed.format_row(r)}")
    assert all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in rows), rows
    ms = {(r["dtype"], r["case"], r["row"]): r["ms"] for r in rows}
    bounds = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).replace("torch.", "")
        total = lambda row: sum(ms[dt, c[0], row] for c in cases)
        bounds[dt] = {c[0]: packed_bound(c[1], c[2], c[3], dtype)[0]
                      for c in cases}
        print(f"microbench over the three cases, {dt}: K5 {total('K5'):.3f} "
              f"ms, K4 {total('K4'):.3f}, cuDNN unpacked "
              f"{total('unpacked'):.3f}, cuDNN dense packed "
              f"{total('dense packed'):.3f}, bound "
              f"{sum(bounds[dt].values()):.3f}")
    for name, *_ in cases:
        lib, bound = ms["bfloat16", name, "unpacked"], bounds["bfloat16"][name]
        print(f"  bfloat16 {name}: " + ", ".join(
            f"{row} {ms['bfloat16', name, row]:.3f} ms "
            f"({ms['bfloat16', name, row] / lib:.2f}x cuDNN unpacked, "
            f"{100 * bound / ms['bfloat16', name, row]:.1f}% of bound)"
            for row in ("K4", "K5")) + f"; cuDNN {lib:.3f}, bound {bound:.3f}")
    by = packed_bound(*max(cases, key=lambda c: bounds["bfloat16"][c[0]])[1:],
                      torch.bfloat16)[1]
    bf16 = {row: {"ms": sum(ms["bfloat16", c[0], row] for c in cases),
                  "library_ms": sum(ms["bfloat16", c[0], "unpacked"]
                                    for c in cases),
                  "bound_ms": sum(bounds["bfloat16"].values()),
                  "bound_by": by}
            for row in ("K4", "K5")}
    return counts, bf16_counts, bf16


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
    3, for TRAIN_STEPS steps, then its evaluation of a TRAIN_EVAL-sample
    eval set at 384x1248; returns the launch counts of the run."""
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
    eval_ds = SyntheticStereoDataset(
        length=TRAIN_EVAL, height=PADDED[0], width=PADDED[1],
        max_disp=cfg["model"]["max_disp"], seed=7,
        transform=transforms.make_eval_transform(PADDED, data["mean"],
                                                 data["std"]))
    with tempfile.TemporaryDirectory() as work:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        state = train_matcher(cfg, work, train_dataset=ds,
                              eval_dataset=eval_ds, max_steps=TRAIN_STEPS,
                              log_interval=1)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        records = read_metrics(work)
        _, meta = CheckpointManager(work).restore()
    n_params = sum(p.numel() for p in state.module.parameters())
    # the steps, and one eval batch at the end (K1 13, K2 3: plain mode)
    assert counts == {"fused_conv3d": 13,
                      "fused_soft_argmin": 3 * TRAIN_STEPS + 3,
                      "fused_soft_argmin_backward": 3 * TRAIN_STEPS,
                      "fused_upsample_soft_argmin": 0,
                      "conv3d_packed_s1": 13 * TRAIN_STEPS,
                      "conv3d_packed_s1_v2": 0}, counts
    per_step = {"conv3d_packed_s1": 13, "fused_soft_argmin": 3,
                "fused_soft_argmin_backward": 3}
    evals = [r for r in records if "eval/disp_0/epe" in r]
    records = [r for r in records if "train/loss" in r]
    assert [r["step"] for r in evals] == [TRAIN_STEPS], evals
    assert all(np.isfinite(v) for v in evals[0].values()), evals
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
          f"GiB; launches per step {per_step}; checkpoint resumes at {meta}; "
          f"eval of {TRAIN_EVAL} samples at {PADDED} logged: disp_0 EPE "
          f"{evals[0]['eval/disp_0/epe']:.4f} px, 3px "
          f"{evals[0]['eval/disp_0/3px']:.4f} %")
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


def write_kitti_dataset(root):
    """KITTI-2015-layout files from SyntheticStereoDataset (seeded,
    disparities 1-191), written with the port's writers: RGB PNGs (pair i
    with PNG row filter i % 5), uint16 disparity PNGs of both views and an
    annotation JSON. Returns its path."""
    from densematchingbenchmark_tpu_torch.data import SyntheticStereoDataset
    from densematchingbenchmark_tpu_torch.data import io as dio
    items = []
    for i, (h, w) in enumerate(EVAL_SIZES):
        s = SyntheticStereoDataset(length=1, height=h, width=w, max_disp=192,
                                   seed=i, with_right_disp=True).load(0)
        item = {"height": h, "width": w}
        for key, sub in (("leftImage", "image_2"), ("rightImage", "image_3"),
                         ("leftDisp", "disp_occ_0"),
                         ("rightDisp", "disp_occ_1")):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
            rel = f"{sub}/{i:06d}_10.png"
            if key.endswith("Disp"):
                dio.save_kitti_disp(os.path.join(root, rel), s[key][..., 0])
            else:
                dio.save_png(os.path.join(root, rel), np.clip(
                    np.round(s[key]), 0, 255).astype(np.uint8), i % 5)
            item[{"leftImage": "left_image_path",
                  "rightImage": "right_image_path",
                  "leftDisp": "left_disp_map_path",
                  "rightDisp": "right_disp_map_path"}[key]] = rel
        items.append(item)
    ann = os.path.join(root, "kitti15.json")
    with open(ann, "w") as fp:
        json.dump(items, fp)
    return ann, items


def metrics_f64(est, gt, right_gt, lb=0, ub=192):
    """Per-sample metrics of one [H, W] estimate in float64 numpy: EPE and
    the n-px shares over all, occluded and non-occluded valid GT pixels
    (occluded: the right GT warped to the left view, linear, zero outside,
    disagrees by more than 1 px or is zero)."""
    est, gt, rgt = (np.asarray(a, np.float64) for a in (est, gt, right_gt))
    w = gt.shape[1]
    xs = np.arange(w)[None, :] - gt
    x0 = np.floor(xs)
    warped = np.zeros_like(gt)
    rows = np.arange(gt.shape[0])[:, None]
    for xi, wt in ((x0, 1 - (xs - x0)), (x0 + 1, xs - x0)):
        inside = (xi >= 0) & (xi <= w - 1)
        warped += np.where(inside, rgt[rows, np.clip(xi, 0, w - 1).astype(
            np.int64)] * wt, 0.0)
    occ = (np.abs(warped - gt) > 1.0) | (np.abs(warped) < 1e-6)
    valid = (gt > lb) & (gt < ub)
    out = {}
    for region, mask in (("", valid), ("occ_", valid & occ),
                         ("noc_", valid & ~occ)):
        err = np.abs(gt - est)[mask]
        for t in (1, 2, 3, 5):
            out[f"{region}{t}px"] = (100.0 * float(np.mean(err > t))
                                     if err.size else 0.0)
        out[f"{region}epe"] = float(err.mean()) if err.size else 0.0
    return out


def compare_metrics(got, want, label):
    """EPE within EVAL_EPE_ATOL px, n-px within EVAL_PX_ATOL points.
    Returns the largest differences (EPE, n-px)."""
    assert set(got) == set(want), (label, sorted(got), sorted(want))
    epe = max(abs(got[k] - want[k]) for k in want if k.endswith("epe"))
    px = max(abs(got[k] - want[k]) for k in want if not k.endswith("epe"))
    assert epe <= EVAL_EPE_ATOL and px <= EVAL_PX_ATOL, (label, epe, px)
    return epe, px


def check_eval_kernels(gen):
    """K1 and K3 against their plain versions at the batch-4 eval shapes,
    with their one-call times beside their bounds."""
    from densematchingbenchmark_tpu_torch.ops.cost_volume import (
        disp_sample_values)
    from densematchingbenchmark_tpu_torch.ops.cuda import (
        conv3d_plain, fused_conv3d, fused_upsample_soft_argmin,
        upsample_soft_argmin_plain)
    errs, k1_ms, k1_bound = [], 0.0, 0.0
    for cin, cout, (d, h, w), per_fwd in CONV_SHAPES:
        x = torch.randn((EVAL_BATCH, d, h, w, cin), device="cuda",
                        generator=gen)
        k = torch.randn((3, 3, 3, cin, cout), device="cuda",
                        generator=gen) * (27 * cin) ** -0.5
        scale = torch.rand(cout, device="cuda", generator=gen) + 0.5
        bias = torch.randn(cout, device="cuda", generator=gen)
        got = fused_conv3d(x, k, scale, bias, relu=True)
        want = conv3d_plain(x, k, scale, bias, True)
        e = (got - want).abs().max().item()
        assert e <= CONV_RTOL * want.abs().max().item(), (cin, cout, d, e)
        errs.append(e)
        vox = EVAL_BATCH * d * h * w
        k1_ms += per_fwd * time_ms(lambda: fused_conv3d(x, k, scale, bias,
                                                        relu=True))
        k1_bound += per_fwd * bound_ms(
            2 * 27 * cin * cout * vox,
            4 * (vox * (cin + cout) + k.numel() + 2 * cout))[0]
        del x, got, want
    low = torch.randn((EVAL_BATCH, *UPSAMPLE_LOW[1:]), device="cuda",
                      generator=gen) * 3
    vals = torch.as_tensor(disp_sample_values(UPSAMPLE_OUT[0]), device="cuda")
    got = fused_upsample_soft_argmin(low, *UPSAMPLE_OUT)
    want = upsample_soft_argmin_plain(low, *UPSAMPLE_OUT, vals)
    k3 = (got - want).abs().max().item()
    assert got.shape == (EVAL_BATCH, *UPSAMPLE_OUT[1:], 1) \
        and k3 <= ARGMIN_ATOL, k3
    k3_ms = time_ms(lambda: fused_upsample_soft_argmin(low, *UPSAMPLE_OUT))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k3_bound = (EVAL_BATCH * UPSAMPLE_OUT[0] * UPSAMPLE_OUT[1]
                * UPSAMPLE_OUT[2] / (EX2_PER_CLOCK_PER_SM * sms
                                     * sm_clock_hz()) * 1e3)
    print(f"eval kernels at batch {EVAL_BATCH}: K1 at the 4 trunk shapes "
          f"max_abs_err {max(errs):.3g} (tolerance {CONV_RTOL} of "
          f"max|plain|), {k1_ms:.3f} ms per forward by one call a launch, "
          f"bound {k1_bound:.3f} (operations); K3 "
          f"{[EVAL_BATCH, *UPSAMPLE_LOW[1:]]} -> {list(UPSAMPLE_OUT)} "
          f"max_abs_err {k3:.3g} px (tolerance {ARGMIN_ATOL}), {k3_ms:.3f} "
          f"ms a launch, bound {k3_bound:.4f} (exponentials)")


def png_decode_phase(smi):
    """Host time of the port's PNG decoder on one 375x1242 RGB frame
    written with each row filter (median of 3)."""
    from densematchingbenchmark_tpu_torch.data import SyntheticStereoDataset
    from densematchingbenchmark_tpu_torch.data import io as dio
    img = np.clip(np.round(SyntheticStereoDataset(
        length=1, height=375, width=1242, max_disp=192).load(0)[
            "leftImage"]), 0, 255).astype(np.uint8)
    times = {}
    for f in range(5):
        png = dio.encode_png(img, f)
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = dio.decode_png(png)
            runs.append((time.perf_counter() - t0) * 1e3)
        assert np.array_equal(got, img), f
        times[f] = float(np.median(runs))
    names = ("None", "Sub", "Up", "Average", "Paeth")
    print("png decode 375x1242 RGB, host ms (median of 3) by row filter: "
          + ", ".join(f"{f} {names[f]} {t:.1f}" for f, t in times.items())
          + f"; {smi}")


def eval_phase(smi, gen):
    """tools/test.py on a KITTI-2015-layout dataset at full width in both
    eval modes, held against a batch-1 inference_stereo reference; the
    eval loop's per-batch work under the sync guard; the restore path.
    Returns the launch counts of the two tools/test.py runs."""
    from densematchingbenchmark_tpu_torch.apis import (inference_stereo,
                                                       init_model)
    from densematchingbenchmark_tpu_torch.configs import get_config
    from densematchingbenchmark_tpu_torch.data import (build_dataset, collate,
                                                       io as dio, transforms)
    from densematchingbenchmark_tpu_torch.evaluation import eval_loop
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    from densematchingbenchmark_tpu_torch.tools import test as test_tool
    from densematchingbenchmark_tpu_torch.utils.checkpoint import (
        CheckpointManager)
    check_eval_kernels(gen)
    torch.cuda.empty_cache()
    launches, by_mode = None, {}
    with tempfile.TemporaryDirectory() as root:
        ann, items = write_kitti_dataset(root)
        work = os.path.join(root, "work")
        for fused in (False, True):
            over = [f"model.eval.fused_upsample_argmin={fused}",
                    "data.test.use_right_disp=True",
                    f"data.test.input_shape={PADDED}"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            results, n = test_tool.main([
                "--config", EVAL_CONFIG, "--work-dir", work, "--data-root",
                root, "--annfile", ann, "--override", *over])
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            regress = ("fused_upsample_soft_argmin" if fused
                       else "fused_soft_argmin")
            want = {k: 0 for k in counts}
            want["fused_conv3d"] = 13 * EVAL_BATCHES
            want[regress] = 3 * EVAL_BATCHES
            assert n == len(EVAL_SIZES) and counts == want, (n, counts)
            launches = ({k: launches[k] + v for k, v in counts.items()}
                        if launches else counts)

            # the reference: batch-1 inference_stereo on the same files,
            # metrics per sample in float64
            cfg = get_config(EVAL_CONFIG, **{
                "model.eval.fused_upsample_argmin": fused})
            model = init_model(cfg, seed=0)
            sums = {}
            for item in items:
                path = lambda k: os.path.join(root, item[k])
                out = inference_stereo(model, [{
                    "leftImage": dio.load_image(path("left_image_path")),
                    "rightImage": dio.load_image(path("right_image_path"))}],
                    pad_to_shape=PADDED)[0]["disps"]
                gt = dio.load_kitti_disp(path("left_disp_map_path"))
                rgt = dio.load_kitti_disp(path("right_disp_map_path"))
                for did, d in enumerate(out):
                    for k, v in metrics_f64(d[0, ..., 0], gt, rgt).items():
                        key = f"disp_{did}/{k}"
                        sums[key] = sums.get(key, 0.0) + v
            ref = {k: v / len(items) for k, v in sums.items()}
            epe, px = compare_metrics(results, ref, f"fused={fused}")

            # the eval loop again, timed end to end (files decoded by the
            # loader threads), then its per-batch work under the sync guard
            test_cfg = dict(cfg["data"], data_root=root, test=dict(
                cfg["data"]["test"], annfile=ann, use_right_disp=True))
            ds = build_dataset(test_cfg, "test",
                               transforms.make_eval_transform(
                                   PADDED, cfg["data"]["mean"],
                                   cfg["data"]["std"]))
            ecfg, ids = cfg["model"]["eval"], cfg["eval_disparity_id"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again, _ = eval_loop.evaluate(model.module, ds, ecfg, ids)
            wall = time.perf_counter() - t0
            compare_metrics(again, results, f"fused={fused} again")
            torch.cuda.set_sync_debug_mode("error")
            try:
                pending, count = eval_loop.eval_batches(model.module, ds,
                                                        ecfg, ids)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            compare_metrics(eval_loop.average_metrics(pending, count),
                            results, f"fused={fused} guarded")
            if "--profile" in sys.argv[1:]:
                device_profile(f"evaluate fused_upsample_argmin={fused}, "
                               f"{n} samples", lambda: eval_loop.evaluate(
                                   model.module, ds, ecfg, ids), reps=1)

            # device time of the eval step (forward + metrics) per sample
            # on a batch staged on the card, at batch 4 and batch 1
            step = eval_loop.make_eval_metrics_step(
                model.module, ecfg["lower_bound"], ecfg["upper_bound"], ids,
                ecfg["eval_occlusion"])
            b4 = eval_loop.to_device(collate([ds[i] for i in range(
                EVAL_BATCH)]), model.device)
            b1 = {k: v[:1] for k, v in b4.items()}
            ms4 = time_ms(lambda: step(b4), 3) / EVAL_BATCH
            ms1 = time_ms(lambda: step(b1), 3)
            by_mode[fused] = results
            print(f"eval {EVAL_CONFIG} fused_upsample_argmin={fused}: "
                  f"{n} samples of {sorted(set(EVAL_SIZES))} padded to "
                  f"{PADDED}, batches of {EVAL_BATCH}; launches {counts}; "
                  f"disp_0 EPE {results['disp_0/epe']:.4f} px, 3px "
                  f"{results['disp_0/3px']:.4f} %, noc EPE "
                  f"{results['disp_0/noc_epe']:.4f}; vs the batch-1 "
                  f"reference: EPE {epe:.3g} px, n-px {px:.3g} points; "
                  f"eval step {ms4:.2f} ms a sample at batch {EVAL_BATCH}, "
                  f"{ms1:.2f} at batch 1 (device, CUDA events); evaluate "
                  f"{n / wall:.2f} samples/s end to end (host clock, "
                  f"files decoded); peak {peak:.2f} GiB at batch "
                  f"{EVAL_BATCH}; no synchronising call per batch; {smi}")
            del model, b4, b1, step
            torch.cuda.empty_cache()
        epe, px = compare_metrics(by_mode[True], by_mode[False], "modes")
        print(f"eval: the two modes agree to {epe:.3g} px EPE and {px:.3g} "
              f"points n-px (tolerances {EVAL_EPE_ATOL}, {EVAL_PX_ATOL})")

        # restore: a checkpoint of a seed-1 model through init_model; the
        # disparities compared with cuDNN held to deterministic algorithms
        # (its default choice may sum in another order from call to call)
        saved = init_model(EVAL_CONFIG, seed=1)
        ckpt = os.path.join(root, "ckpt")
        CheckpointManager(ckpt).save(1, {"module": saved.module.state_dict()})
        restored = init_model(EVAL_CONFIG, seed=0, checkpoint_dir=ckpt)
        sa, sb = saved.module.state_dict(), restored.module.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k])
                                              for k in sa)
        x = torch.randn((1, *PADDED, 3), generator=torch.Generator()
                        .manual_seed(0)).to(saved.device)
        spread = max((p - q).abs().max().item() for p, q in zip(
            saved.forward(x, x)["disps"], saved.forward(x, x)["disps"]))
        torch.backends.cudnn.deterministic = True
        try:
            a = saved.forward(x, x)["disps"]
            b = restored.forward(x, x)["disps"]
        finally:
            torch.backends.cudnn.deterministic = False
        assert all(torch.equal(p, q) for p, q in zip(a, b)), max(
            (p - q).abs().max().item() for p, q in zip(a, b))
        print("restore: init_model(checkpoint_dir=...) restores every "
              "parameter and BN statistic exactly, and its disparities are "
              "identical to the saved module's (cuDNN deterministic; two "
              f"forwards of one module in cuDNN's default mode differ by "
              f"up to {spread:.3g} px)")
        del saved, restored, a, b
    return launches


def bench_phase(smi):
    """tools/bench.py's JSON line, beside the card's name and power
    limit."""
    from densematchingbenchmark_tpu_torch.tools import bench
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        record = bench.main([])
    assert record["value"] > 0 and json.loads(out.getvalue()) == record
    print(f"bench (tools/bench.py): {json.dumps(record)}; {smi}")


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
    smi = device_phase()
    build_phase()
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    gen = torch.Generator(device="cuda").manual_seed(0)
    stats = {"fused_conv3d": check_conv("cuda", gen),
             "fused_soft_argmin": check_soft_argmin("cuda", gen),
             "fused_upsample_soft_argmin": check_upsample("cuda", gen),
             "conv3d_packed_s1": check_packed_conv("cuda", gen),
             "fused_soft_argmin_backward": check_soft_argmin_backward(
                 "cuda", gen)}
    stats["conv3d_packed_s1_v2"], bf16_check = check_packed_v2("cuda", gen)
    torch.cuda.empty_cache()
    print("sync guard (torch.cuda.set_sync_debug_mode('error')):")
    sync_guard_phase(gen)
    torch.cuda.empty_cache()
    micro, micro_bf16, bf16_times = microbench_phase()
    torch.cuda.empty_cache()
    launches, models = slice_phase()
    for name, n in micro.items():
        launches[name] += n
    if "--profile" in sys.argv[1:]:
        profile_phase(models)
    del models
    torch.cuda.empty_cache()
    for name, n in eval_phase(smi, gen).items():
        launches[name] += n
    png_decode_phase(smi)
    torch.cuda.empty_cache()
    bench_phase(smi)
    torch.cuda.empty_cache()
    for name, n in train_phase().items():
        launches[name] += n
    same_weights_phase()
    overfit_phase()
    rows = []
    for k in kernels.KERNELS:
        name = k.__name__
        route, source, replaces = SOURCES[name]
        # the float32 (CUDA-core) row; a bfloat16 route has its own row
        n = launches[name] - micro_bf16.get(name, 0)
        assert n > 0, f"{name} never launched on a main path"
        rows.append({"name": name, "route": route, "source": source,
                     "replaces": replaces, "launches": n, **stats[name]})
        if name in BF16_SOURCES:
            row_name, label = BF16_SOURCES[name]
            assert micro_bf16[name] > 0, f"{row_name} never launched"
            rows.append({"name": row_name, "route": "cuda",
                         "source": WGMMA_SOURCE, "replaces": replaces,
                         "launches": micro_bf16[name],
                         "unit": "per microbench case set (3 cases, pack 4, "
                                 "bfloat16)",
                         "max_abs_err": bf16_check[label],
                         "plain_ms": bf16_check["plain_ms"],
                         **bf16_times[label]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
