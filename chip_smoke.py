#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port (densematchingbenchmark_tpu_torch) through its own entry
points and holds every hand-written kernel of its paths against its plain
PyTorch version on the card. Phases, each fatal on failure:

  1. device: needs CUDA; prints the card's name and power limit
     (nvidia-smi) and turns TF32 off for matmuls and cuDNN convolutions.
  2. build: compiles the CUDA C++ kernels from csrc/ (one nvcc per source,
     all at once) and the host library csrc/dmb_native.cpp (g++, the data
     pipeline's PNG and PFM decoders) and prints the build seconds and
     ptxas's report; asserts
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
  3e. bfloat16 kernels: K4's bfloat16 (wgmma) route at pack 1, as the
     bfloat16 trunk calls it, at the four trunk shapes of the 384x1248
     forward at batch 1 and 4 (tools/bench_trunk_conv.measure_shape): the
     eval unit's call on its kept operands and the per-call route of
     training, with the folded-BN [Co] epilogue and ReLU on and off,
     against the plain version (within BF16_STEP); the unit's call by one
     call and over 20 in a row, the kernel alone on prepared operands
     chained, the per-call route, cuDNN's bf16 F.conv3d + affine + ReLU and
     the bound at 989 TFLOP/s (with --profile the kernel's device time and
     the unit call's launches); K2 (forward, and its backward through
     autograd and alone, one call and chained, beside its bound) and K3 on
     bfloat16 costs at the path's shapes.
  3d. no synchronising copy: torch.cuda.set_sync_debug_mode("error")
     around a second call (the first fills the caches) of K3, the K2
     forward and backward, upsample_3d, K5 in float32, and the eval forward
     of a tiny PSMNet in each eval mode and each compute dtype on inputs
     already on the card.
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
     through the plain versions on the CPU. Then the same in bfloat16
     (PSMNet/scene_flow_bf16, seed 0: K4's bfloat16 route 13 launches a
     forward, K1 none; the trunk's K4 operands built in the first frame
     and in none after), its disparities against the float32 model's (mean
     gap within BF16_GAP_ATOL), its forward time, peak memory and the
     forward under the sync guard.
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
     disparities exactly. The same six pairs through tools/test.main on
     PSMNet/kitti_2015_bf16 in both modes (K4's bfloat16 route 26 launches,
     K1 none; each EPE within BF16_GAP_ATOL of the float32 eval's; the
     per-batch work under the sync guard; eval ms a sample and peak
     memory). The PNG files are read by the host library
     (csrc/dmb_native.cpp, built with g++ in the build phase) in the
     loader threads; each mode prints evaluate's samples/s and the card's
     busy share over one evaluate (torch.profiler). Then the PNG
     decoders' host time on one 375x1242 RGB frame per row filter, the
     host library beside its plain version (the numpy codec), bitwise
     equal, the PPM reader's on the same frame, and the host library's
     decode rate over 20 such files in four threads against one (ctypes
     and zlib release the GIL; four must beat one by 1.2x); and
     tools/bench.py's JSON line in float32 and in bfloat16; each of these
     lines carries the card's name and power limit.
  5. train: trainer.loop.train_matcher on PSMNet/scene_flow_f32 at full
     width, its own 256x512 crop and batch 3 of SyntheticStereoDataset, for
     5 steps, then its evaluation of a two-sample synthetic eval set at
     384x1248, with the launches asserted (per step K4 13, K2 3 forward and
     3 backward, K1 and K3 none; the eval batch K1 13 and K2 3), finite
     losses, 'eval/' metrics in metrics.log.json, the step time,
     samples/s, peak memory and the checkpoint's resume position. Then
     the same on PSMNet/scene_flow_bf16 (K4's bfloat16 route 13 launches a
     step and 13 for the eval batch, K1 none; the parameters float32).
  6. same weights: one train step at a small size on the card and on the
     CPU (the plain versions) from the same weights and batch: loss,
     per-parameter gradient cosine and updated parameters.
  7. overfit: 24 train steps on one batch at a tiny size (max_disp 32,
     crop 64x96, lr 2e-3, no warmup); the loss must fall below 0.7x its
     first value and the batch's EPE must fall.
  8. bfloat16 card vs CPU: a small bfloat16 model from the same weights
     and inputs on the card and through the plain versions on the CPU,
     both eval modes (mean disparity gap within BF16_CPU_ATOL), and one
     train step (losses within BF16_LOSS_RTOL, gradients float32).
  3f. bias epilogue (run after 3e): a trunk unit with a conv bias (AcfNet's
     7 aggregator units outside the hourglasses) in eval at its two
     shapes, 64->32 and 32->32 at 48x96x312: K1 in float32 and K4's
     bfloat16 route on the unit's kept operands, the bias folded into the
     shift, against the plain version (CONV_RTOL; BF16_STEP besides) and
     the unfused conv + bias, BN, ReLU; an in-place change of the bias
     alone rebuilds the kept operands once.
  9. AcfNet: init_model("AcfNet/scene_flow_adaptive_{f32,bf16}", seed 0)
     at full width (max_disp 192, cmn in_planes 192) and inference_stereo
     over three random 375x1242 pairs padded to 384x1248 (per forward K1
     13 or K4's bf16 route 13, K2 3, K3 none; disparities finite in [0,
     191], confidences in [0, 1]; forward ms; peak), the bf16-vs-float32
     gap on the same weights, and a small model on the card against the
     CPU in each dtype (CPU_ATOL max, BF16_CPU_ATOL mean). Then
     tools/test.main on AcfNet/kitti_2015_adaptive over the eval phase's
     six KITTI-layout pairs: float32 at batch 4 and at batch 1 (metrics
     within the eval tolerances of each other), bf16 at batch 4 (EPE
     within BF16_GAP_ATOL of float32's), each with its sparsification
     pass and est / oracle / random rows, launches asserted; the eval
     step's ms a sample and peak at batch 4 and 1. Then train_matcher on
     AcfNet/scene_flow_adaptive for 5 steps at 256x512 batch 3 in each
     dtype and on the uniform config for one (a step K4 13, K2 3 forward
     and 3 backward; every focal and confidence loss finite; step ms and
     peak), and tools/train.main --profile 2:3 on the uniform config
     (--synthetic 256x512): the torch.profiler trace and the vis panels.
     Its launches join the kernels line's counts.
 10. StereoNet (8x; max_disp 192, 24 cost disparities at 1/8): K1 and
     K4's bfloat16 route as the biased 32->32 eval unit at 24x48x156,
     batch 1 and 4, against the plain version and the unfused conv + bias,
     BN, ReLU, with one call, chained, cuDNN and the bound; K4's training
     route at 4x24x32x64 in both dtypes, forward and backward against the
     plain autograd; K2 at 24 disparities (forward at the eval costs,
     forward and backward at the training cost). Fault 8 (the width
     dispatch): fusable units of 128->128, 65->64 and 32->32 in both
     dtypes, eval and training, run on their kernels at widths the blocks
     take (zero channels; 128 in bfloat16 as two Ci slices), one launch a
     slice and no library conv, against the CPU.
     Then init_model("StereoNet/scene_flow_8x_4stage_{f32,bf16}", seed 0)
     + inference_stereo over three random 375x1242 pairs padded to
     384x1248 and the 2-stage config over one, launches asserted (a
     forward K1 4 or K4's bf16 route 4, K2 1, K3 none), the forward's ms
     and its layers' (the refinement's share), the bf16-vs-float32 gap on
     the same weights, a small model on the card against the CPU in each
     dtype. tools/test.main on the 4-stage config in both dtypes over six
     SceneFlow-layout pairs the script writes (540x960 PNGs, PFM
     disparities of both views, an annotation JSON) padded to 544x960 at
     eval batch 4, all four disparities scored, against batch-1
     inference_stereo with float64 per-sample metrics; the eval step's ms
     and peak at batch 4 and 1. train_matcher on the 4-stage config for 5
     steps in each dtype at its 4x256x512 (a step K4 4, K2 1 forward and
     1 backward).
 11. GCNet (max_disp 192; 96 disparities at half resolution): fault 9,
     c19 on the raw volume of the 544x960 batch-4 eval ([4, 96, 272, 480,
     64], past 2^31 elements) on K1 and K4's bf16 route, one launch each,
     against cuDNN's conv + BN + ReLU; its 10 stride-1 units at 384x1248
     on K1 and K4's bf16 route (12 launches, c31-c32 in two Cin slices)
     and on K4's training route at 1x256x512, each against the plain
     version (the eval units also against the unfused conv, BN, ReLU),
     with cuDNN and the bound; init_model("GCNet/scene_flow_{f32,bf16}")
     + inference_stereo over three 375x1242 pairs padded to 384x1248 (a
     forward K1 10 or K4 bf16 12, K2 1), the layers' times, the
     bf16-vs-float32 gap (above 0), a small model against the CPU;
     tools/test.main over the SceneFlow-layout set at 544x960 batch 4
     against batch 1 (peak memory printed); train_matcher at 1x256x512.
 12. DeepPruner 4x and 8x: its 20 stride-1 units at the 4x 384x1280
     shapes on K1 and K4's bf16 route (23 launches) and on K4's training
     route at 5x256x512; each config's inference over three pairs padded
     to 384x1280 (JAX's 8x model, like the port's, takes sides that are
     multiples of 64 only), launches asserted (K1 20 or K4 bf16 23, no
     K2), the layers' times, the bf16-vs-float32 gap (every disparity
     within BF16_GAP_ATOL, the predicted range's above 0); a small 4x and
     8x model against the CPU; tools/test.main at batch 4 against batch 1 (4x at
     544x960, 8x at 576x960); train_matcher at 5x256x512.
  13. AnyNet (scene_flow, its full width): its 15 pre-norm aggregator
     units (BN -> ReLU on the input, then the conv with its bias) on K1
     and K4's bf16 route at the 384x1248 shapes (8->16 and 16->16 at
     12x24x78, 4->4 at 5x48x156, 2->4 and 4->4 at 5x96x312) and on K4's
     training route at 6x256x512, against the unfused BN -> ReLU -> conv
     (+ bias); K2 at its three costs (12 samples from 0, 5 from -2);
     inference over three pairs padded to 384x1248 in both
     dtypes, launches asserted (K1 15 or K4 bf16 15, K2 3), the layers'
     times, the bf16-vs-float32 gap (every disparity within
     BF16_GAP_ATOL, the three stages' above 0); a small model against the
     CPU; tools/test.main at 544x960 batch 4 against batch 1;
     train_matcher at 6x256x512 (a step K4 15, K2 3 and its backward 3).
 14. Optical flow (PWCFlow/flying_chairs, RAFT/flying_chairs; full
     width, random weights from seed 0 peaked by peak_flow): a
     FlyingChairs-layout set written here (16 pairs of 384x512 binary PPM
     frames, .flo ground truth, annotation JSONs) read through data/io's
     PPM reader; init_flow_model + inference_flow at 384x512 batch 1 in
     both dtypes (PWCFlow 5 flows, RAFT 9, finite, the best flow's mean
     |flow| at least FLOW_MIN_MAG; forward ms, launches, device busy ms,
     peak; the card's bf16-vs-float32 gap 0.8-1.25 times the CPU's own on
     the same weights); a small model of each on the card against the
     CPU (CPU_ATOL max in float32, BF16_CPU_ATOL mean in bfloat16) and a
     float32 train step's losses and gradients; tools/test.main over 4
     pairs in both dtypes with --out-dir, its EPE and n-px against
     float64 host metrics of the written flows; tools/train.main for 5
     steps at the configs' 8x320x448 crops with the per-epoch eval and
     vis hook (step ms, peak); tools/demo.main on one pair. The port's
     kernel counters stay 0 across the phase: the flow paths launch none
     of K1-K5.
 15. Data parallelism: PSMNet/scene_flow at full width, its 256x512 crop,
     3 steps at a global batch of 6 (train_matcher): two ranks spawned on
     the one card (cuda:0 named for both; gloo, since NCCL refuses two
     ranks on one GPU) at its batch_size_per_device of 3, against one
     rank at 6 in this process on the same seeded weights and data. In
     float32 (TF32 off) the first step's loss within PAR_LOSS_RTOL, its
     BN statistics within PAR_STATE_TOL of their largest value and each
     parameter's gradient's cosine above PAR_GRAD_COS; the later
     steps' losses and the parameters and BN statistics after the last
     are printed beside the same numbers of one rank whose weights were
     perturbed by 1e-7 (the floor after RMSprop's first update, in each
     dtype); in bfloat16 the first step's loss within PAR_BF16_LOSS_RTOL;
     in both
     the ranks' gradients and parameters bitwise equal and on each rank
     K4 13 and K2 3 + 3 launches a step. Then one rank of an
     NCCL group (tools/train.main --launcher env, WORLD_SIZE 1), 2 steps
     and its per-epoch eval, with its collective calls counted (the
     gradient all-reduce, the losses' counts, combine_shard_metrics, the
     broadcast, the checkpoint's barrier). The step times of 1 x 6 and 2
     x 3 are printed: times of the check, not a speed claim (the pair's
     all-reduces go through the host).
 16. Correlation: PSMNet/scene_flow with model.cost_processor.type
     Correlation (the one-channel volume of
     ops.cost_volume.correlation1d_volume; the first trunk unit 1 -> 32,
     padded with zero channels to its kernels' widths) at full width,
     seed 0 with BN drawn by damp_bn (at seed 0 its costs are far larger
     than the concatenation model's and the soft-argmin a hard argmax:
     the largest |cost| of each is printed), through init_model +
     inference_stereo over three random 375x1242 pairs padded to
     384x1248, in both eval modes and both dtypes, launches asserted
     (float32: K1 13 a forward; bfloat16: K4's bfloat16 route 13, K1
     none; K2 or K3 3), the kept operands built in the first frame only,
     each forward under the sync guard; the modes against each other
     (MODES_ATOL scaled by the costs' size over the concatenation
     model's), bfloat16 against float32 (mean gap within BF16_GAP_ATOL),
     the first trunk unit as the main path ran it against its plain
     version (K1 with Ci padded 1 -> 4, K4's bfloat16 route 1 -> 16;
     CONV_RTOL, BF16_STEP besides in bfloat16), the card against the
     plain versions on the CPU on a small pair (CORR_CPU_ATOL), a small
     model in each dtype against the CPU (corr_small_vs_cpu: in bfloat16
     by the CPU's own bfloat16 gap); train_matcher for 3 steps at
     3x256x512 in float32 (K4 13 a step, K2 3 and its backward 3); one
     float32 forward of GCNet (K1 10) and AcfNet uniform (K1 13) with a
     correlation volume; forward ms (CUDA events) and peak memory. Its
     launches join each dtype's counts.
 17. Tools: the port's measurement tools through their main(argv):
     tools/benchmark.py over every family in each dtype (--iters 3: the
     zoo table's parameters, GFLOPs, latency and frames/s),
     tools/train_throughput.py over every family (--iters 2),
     tools/profile_model.py on PSMNet's forward and on its train step
     (Chrome trace, top kernels, busy share, launches) and
     tools/loader_throughput.py on six SceneFlow-shaped pairs against the
     PSMNet step just measured; every row's times finite and positive,
     the zoo's parameter count the built module's, GFLOPs present; the
     phase's seconds.
 18. Convergence gauntlet: tools/convergence_gauntlet.py's overfit mode on
     each of its 11 families (its config names: bfloat16 on the card) at
     full width, 24 steps on one batch of 2 (GCNet 1) at 128x256 with
     JAX's CPU test's lr 2e-3 and no warmup: the loss below 0.7 of its
     first value and the batch's EPE down (AcfNet-adaptive: its loss down,
     GAUNTLET_DESCENT_ONLY) at its first run or, when that misses, in a
     majority of GAUNTLET_RUNS runs, launches asserted in every run (each
     stereo step and eval
     forward K4's bfloat16 route and K2 by GAUNTLET_LAUNCHES, K2's
     backward each step; flow none of K1-K5), each family's seconds.
 19. Library pieces no shipped config reaches: DilatedHourglass3D(32) at
     PSMNet's hourglass input (1x48x96x312x32) in float32 eval (K1 2
     launches), bfloat16 eval (K4's bfloat16 route 2) and a float32
     training step (K4 2), each stride-1 unit against its plain version
     (CONV_RTOL, BF16_STEP besides); Hourglass2D, DenseAspp,
     WarpErrorRefinement, CostVolumeNorm, the confidence measures,
     propagation, the bilateral filter and the relative and
     self-supervised losses on the card against the CPU.
 20. tools/view_cost.py on PSMNet/scene_flow (bfloat16) and _f32: PNGs
     read back by data/io.decode_png, the float32 curves against the CPU's
     on the same weights; tools/bf16_convergence.py for 40 steps at
     2x128x256: both curves finite and falling.
 21. D-sharded cost volume (parallel/mesh.py): PSMNet/scene_flow at full
     width, its cost volume split along D over the model axis of a grid
     of gloo ranks on cuda:0 (collectives through the host), each against
     one process on the same seeded weights and data. Eval: a (1, 2)
     grid, one random normalised 384x1248 pair, float32 and bfloat16,
     both eval modes; each rank's disparities against the one process's
     (D_F32_ATOL, D_BF16_ATOL); launches a forward per rank: K1 13 in
     float32, K4's bfloat16 route 13 in bfloat16 (the dres and classify
     units on 24 + 2 planes), K2 or K3 3. Training: train_matcher(mesh=,
     use_volume_sharding=True) on a (1, 2) grid for D_STEPS steps at
     256x512, global batch 3, and on a (2, 2) grid for D_GRID_STEPS steps
     at a global batch of 2, each against one process at its global batch:
     the first step's loss, gradient cosines and BN statistics within
     phase 15's PAR_* bounds, the ranks' parameters bitwise equal, K4 13
     and K2 3 + 3 a step per rank. Prints each rank's peak memory beside
     the one process's, the collective calls and bytes of a forward and of
     a step, and the phase's seconds: a check on one card, not a speed.
 22. Study tools: tools/eval_batch_study.py --n 16 --batches 1 4 (its
     default config, StereoNet/scene_flow_8x_2stage in bfloat16, at its
     384x1248 frame): ms a sample at batch 1 and 4 end to end, the EPE
     the same within EVAL_EPE_ATOL; tools/dsharding_halo_study.py
     --n-model 2 (PSMNet's aggregator at [1, 48, 96, 312, 64] on a (1, 2)
     grid of gloo ranks on cuda:0): the collectives of a forward (7
     halos, 2 gathers), the bytes a rank receives, the one-process
     forward measured by CUDA events, and the break-even link rate: a
     model at NVLink's rate, not a measured multi-GPU speed.

Prints a JSON line of per-kernel numbers before the last line (K4's and
K5's bfloat16 routes in the microbench in rows of their own, ``*_bf16``,
and K4's bfloat16 route on the bfloat16 model's trunk in
``conv3d_packed_s1_bf16_pack1``), and as the last line {"ok": true,
"device": {...}}. Imports nothing of JAX.

    python3 chip_smoke.py --profile

adds, before the JSON lines, the device time by kernel name
(torch.profiler; the bfloat16 conv block's, K4's, on a line of its own),
the launch count and the device's busy share of one forward in each eval
mode, of one evaluate over the eval phase's six pairs in each mode, and
of one training step at 256x512 batch 3, in float32 and in bfloat16; and
the same for AcfNet's forward, train step and eval step, with the device
time of its learned upsample's and ConfHead's convolutions named, and for
StereoNet's 4-stage forward, eval step and train step, and the forward
and eval step of GCNet and of DeepPruner 4x and 8x in each dtype; and
AnyNet's forward by layer (the backbone, each stage, the refinement and
its SPN scan alone), its launches a forward and the scan's share of them,
and the scan alone forward and with its backward; and each flow model's
forward at 384x512 in each dtype, and PWCFlow's correlation volume alone
at each level.
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

# the profiler's per-kernel breakdown, shared with the port's tool
from densematchingbenchmark_tpu_torch.tools.profile_model import (
    device_profile)

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
BF16_EVAL_CONFIG = "PSMNet/kitti_2015_bf16"
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
# bfloat16 compute (PSMNet/*_bf16: float32 parameters and BN statistics,
# bfloat16 activations and convolutions, a float32 soft-argmin)
BF16_GAP_ATOL = 3.0    # px, the mean |bf16 - float32| disparity gap of the
                       # full-width model with random weights (seed 0). The
                       # rounding noise grows through the network and the
                       # peaked softmax of its costs: on the CPU, on the
                       # same network and seed, JAX's own bf16-vs-float32
                       # gap is 0.27-0.43 px mean at 96x192 and 0.34-0.78 at
                       # 192x624, the port's 0.27-0.40 and 0.35-0.79
                       # (tests/bf16_gap_study.py); on the card at 384x1248
                       # the port's measured 1.21-1.96. It bounds the EPE
                       # gap of the eval too, and the gap of PSMNet with a
                       # correlation volume (BN drawn by damp_bn: 2.17-2.25
                       # px measured on the card at 384x1248).
BF16_CPU_ATOL = 0.05   # px, mean |card - CPU| of a small bfloat16 model
                       # with BN drawn as the CPU tests draw it (damp_bn):
                       # the bound they hold the port to against JAX; its
                       # own bf16-vs-float32 gap on the CPU is 0.022-0.036
                       # (tests/bf16_gap_study.py)
BF16_LOSS_RTOL = 0.01  # card vs CPU loss of a bfloat16 train step

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
# the bfloat16 routes of K4 and K5 (their wgmma blocks), rows of their own
BF16_SOURCES = {
    "conv3d_packed_s1": ("conv3d_packed_s1_bf16", "K4",
                         "densematchingbenchmark_tpu_torch/csrc/conv3d_wgmma_persistent.cuh"),
    "conv3d_packed_s1_v2": ("conv3d_packed_s1_v2_bf16", "K5",
                            "densematchingbenchmark_tpu_torch/csrc/conv3d_wgmma.cuh"),
}


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
    each thread's registers. On a bfloat16 cost a thread holds eight
    columns and the float32 result is stored four a thread, so one layout
    change through shared memory (one barrier, two shared stores and
    loads) follows the loop, once a program. Returns the line's text."""
    from densematchingbenchmark_tpu_torch.ops.cuda import (
        soft_argmin_kernel as sak)
    b, d, h, w = cost.shape
    triton, kernel, _ = sak._triton_kernels()
    out = torch.empty((b, h, w, 1), device=cost.device)
    block_w = sak.fwd_block_w(cost.dtype)
    compiled = kernel[(triton.cdiv(w, block_w), h, b)](
        cost, vals, out, out, out, d, h, w, 1.0, STATS=False,
        DEPTH=sak.FWD_DEPTH, BLOCK_W=block_w, num_warps=sak.FWD_WARPS,
        num_stages=1)
    ptx = compiled.asm["ptx"]
    counts = {k: ptx.count(k) for k in ("bar.sync", "bar.arrive",
                                        "barrier.sync", "ld.shared",
                                        "st.shared")}
    allowed = ({"bar.sync": 1, "ld.shared": 2, "st.shared": 2}
               if cost.dtype == torch.bfloat16 else {})
    assert all(n <= allowed.get(k, 0) for k, n in counts.items()), counts
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
    call = lambda: fused_soft_argmin_backward(c, vals, 1.0, out, m, l, g)
    ms, chain = time_ms(call), chained_ms(call)
    plain_out = soft_argmin_plain(cost, vals)
    plain = time_ms(lambda: torch.autograd.grad(plain_out, cost, g,
                                                retain_graph=True), 3)
    # per cost value: scale, subtract, exp, subtract, 3 multiplies; reads
    # the cost and writes its gradient once, plus the per-pixel terms
    b_ms, b_by = bound_ms(7 * c.numel(),
                          4 * (2 * c.numel() + 4 * b * h * w + d))
    print(f"K2 fused_soft_argmin_backward {list(TRAIN_ARGMIN_SHAPE)} "
          f"(x3/step): {ms:.3f} ms, chained {chain:.3f}, plain (autograd of "
          f"softmax + sum) {plain:.3f}, bound {b_ms:.3f} ({b_by}), "
          f"max_abs_err {err:.3g}")
    return {"unit": "per launch", "max_abs_err": err, "ms": ms,
            "chained_ms": chain, "plain_ms": plain, "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by}


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
    tiny PSMNet's eval forward in both modes and both compute dtypes, issue
    no synchronising call once their caches are filled."""
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
    for name in ("PSMNet/scene_flow_f32", "PSMNet/scene_flow_bf16"):
        for fused in (False, True):
            model = init_model(name, device="cuda", seed=0, **dict(
                SYNC_TINY, **{"model.eval.fused_upsample_argmin": fused}))
            guarded(f"{name} eval forward, fused_upsample_argmin={fused}",
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
    return launches, (model_a, model_b), pairs, (disps_a, disps_b)


def train_phase(smi, name="PSMNet/scene_flow_f32"):
    """train_matcher on ``name`` (PSMNet/scene_flow in float32 or bfloat16
    compute) at full width, 256x512 batch 3, for TRAIN_STEPS steps, then
    its evaluation of a TRAIN_EVAL-sample eval set at 384x1248; returns the
    launch counts of the run. In bfloat16 every K4 launch is its
    tensor-core route and K1 stays idle (the eval batch's trunk is K4's
    too); the parameters stay float32."""
    from densematchingbenchmark_tpu_torch.configs import get_config
    from densematchingbenchmark_tpu_torch.data import (SyntheticStereoDataset,
                                                       transforms)
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    from densematchingbenchmark_tpu_torch.trainer import train_matcher
    from densematchingbenchmark_tpu_torch.trainer.loop import read_metrics
    from densematchingbenchmark_tpu_torch.utils.checkpoint import (
        CheckpointManager)
    cfg = get_config(name)
    bf16 = cfg["model"]["dtype"] == "bfloat16"
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
        bf16_counts = kernels.bf16_launch_counts()
        records = read_metrics(work)
        _, meta = CheckpointManager(work).restore()
        vis = sorted(os.listdir(os.path.join(work, "vis")))
    # the vis hook drew the eval set's samples after the epoch
    assert vis == [f"sample_{i:03d}" for i in range(TRAIN_EVAL)], vis
    n_params = sum(p.numel() for p in state.module.parameters())
    assert all(p.dtype == torch.float32 for p in state.module.parameters())
    # the steps, then one eval batch and the vis hook's TRAIN_EVAL batch-1
    # forwards at the end (their 13 trunk units each on K1 in float32, on
    # K4 in bfloat16; K2 3 each: plain mode)
    forwards = 1 + TRAIN_EVAL
    k4 = 13 * TRAIN_STEPS + (13 * forwards if bf16 else 0)
    assert counts == {"fused_conv3d": 0 if bf16 else 13 * forwards,
                      "fused_soft_argmin": 3 * TRAIN_STEPS + 3 * forwards,
                      "fused_soft_argmin_backward": 3 * TRAIN_STEPS,
                      "fused_upsample_soft_argmin": 0,
                      "conv3d_packed_s1": k4,
                      "conv3d_packed_s1_v2": 0}, counts
    assert bf16_counts == {"conv3d_packed_s1": k4 if bf16 else 0,
                           "conv3d_packed_s1_v2": 0}, bf16_counts
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
    print(f"train: {name} {n_params / 1e6:.3f} M params, "
          f"{TRAIN_BATCH}x{crop[0]}x{crop[1]}, {TRAIN_STEPS} steps: losses "
          f"{[round(x, 4) for x in losses]}, grad_norm "
          f"{[round(r['train/grad_norm'], 3) for r in records]}; step "
          f"{step_ms:.2f} ms (median of steps 2-{TRAIN_STEPS}, host clock), "
          f"{TRAIN_BATCH / step_ms * 1e3:.2f} samples/s, peak {peak:.2f} "
          f"GiB; launches per step {per_step}; checkpoint resumes at {meta}; "
          f"eval of {TRAIN_EVAL} samples at {PADDED} logged: disp_0 EPE "
          f"{evals[0]['eval/disp_0/epe']:.4f} px, 3px "
          f"{evals[0]['eval/disp_0/3px']:.4f} %; vis panels of "
          f"{TRAIN_EVAL} samples; {smi}")
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


def compare_metrics(got, want, label, atol=(EVAL_EPE_ATOL, EVAL_PX_ATOL)):
    """EPE within ``atol[0]`` px (EVAL_EPE_ATOL), n-px within ``atol[1]``
    points (EVAL_PX_ATOL). Returns the largest differences (EPE, n-px)."""
    assert set(got) == set(want), (label, sorted(got), sorted(want))
    epe = max(abs(got[k] - want[k]) for k in want if k.endswith("epe"))
    px = max(abs(got[k] - want[k]) for k in want if not k.endswith("epe"))
    assert epe <= atol[0] and px <= atol[1], (label, epe, px)
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
    """Host time of the port's PNG decoders on one 375x1242 RGB frame
    written with each row filter: the host library (native) beside its
    plain version (the numpy codec), bitwise equal; the PPM reader on the
    same frame; and native decodes of files in four threads against one
    (ctypes releases the GIL for the call, zlib for the inflate)."""
    from concurrent.futures import ThreadPoolExecutor
    from densematchingbenchmark_tpu_torch import native
    from densematchingbenchmark_tpu_torch.data import SyntheticStereoDataset
    from densematchingbenchmark_tpu_torch.data import io as dio

    def median_ms(fn, reps):
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            runs.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(runs)), out

    img = np.clip(np.round(SyntheticStereoDataset(
        length=1, height=375, width=1242, max_disp=192).load(0)[
            "leftImage"]), 0, 255).astype(np.uint8)
    names = ("None", "Sub", "Up", "Average", "Paeth")
    pngs, rows = [], []
    for f in range(5):
        png = dio.encode_png(img, f)
        pngs.append(png)
        fast, got = median_ms(lambda: native.decode_png(png), 5)
        slow, want = median_ms(lambda: dio.image_rgb(dio.decode_png(png)),
                               3)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)) \
            and np.array_equal(want, img.astype(np.float32)), f
        rows.append(f"{f} {names[f]} {fast:.2f} / {slow:.1f}")
    ppm = dio.encode_pnm(img)
    ppm_ms, got = median_ms(lambda: dio.image_rgb(dio.decode_pnm(ppm)), 5)
    assert np.array_equal(got, img.astype(np.float32))
    print("png decode 375x1242 RGB, host ms (median of 5 / 3) by row "
          "filter, native (csrc/dmb_native.cpp) / plain (numpy codec), "
          "bitwise equal: " + ", ".join(rows) + f"; PPM (decode_pnm, "
          f"numpy) {ppm_ms:.2f}; {smi}")
    with tempfile.TemporaryDirectory() as root:
        paths = []
        for i in range(20):
            paths.append(os.path.join(root, f"{i:02d}.png"))
            with open(paths[-1], "wb") as fp:
                fp.write(pngs[i % 5])
        serial = [dio.load_image(p) for p in paths]      # warm: page cache
        one, _ = median_ms(lambda: [dio.load_image(p) for p in paths], 3)
        with ThreadPoolExecutor(4) as pool:
            four, threaded = median_ms(
                lambda: list(pool.map(dio.load_image, paths)), 3)
    assert all(np.array_equal(a, b) for a, b in zip(threaded, serial))
    print(f"png decode threads: load_image (native) over {len(paths)} "
          f"375x1242 files of the five filters, {len(paths) / one * 1e3:.1f}"
          f" frames/s in one thread, {len(paths) / four * 1e3:.1f} in four "
          f"({one / four:.2f}x; {os.cpu_count()} host CPUs); {smi}")
    assert one / four > 1.2, (one, four)


def eval_phase(smi, gen, root, ann, items):
    """tools/test.py on the KITTI-2015-layout dataset at ``root`` at full
    width in both eval modes, held against a batch-1 inference_stereo
    reference; the eval loop's per-batch work under the sync guard; the
    restore path. Returns the launch counts of the two tools/test.py runs
    and each mode's metrics."""
    from densematchingbenchmark_tpu_torch.apis import (inference_stereo,
                                                       init_model)
    from densematchingbenchmark_tpu_torch.configs import get_config
    from densematchingbenchmark_tpu_torch.data import collate, io as dio
    from densematchingbenchmark_tpu_torch.evaluation import eval_loop
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    from densematchingbenchmark_tpu_torch.tools import test as test_tool
    from densematchingbenchmark_tpu_torch.utils.checkpoint import (
        CheckpointManager)
    check_eval_kernels(gen)
    torch.cuda.empty_cache()
    launches, by_mode = None, {}
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
        ds = eval_dataset(cfg, root, ann)
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
        # the card's busy share over one evaluate (the PNG files decoded
        # by the host library in the loader threads)
        prof = device_profile(
            f"evaluate fused_upsample_argmin={fused}, {n} samples",
            lambda: eval_loop.evaluate(model.module, ds, ecfg, ids), reps=1,
            top=14 if "--profile" in sys.argv[1:] else 0)

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
              f"{n / wall:.2f} samples/s end to end (host clock, PNG "
              f"files decoded by the host library), the card busy "
              f"{100 * prof['busy_ms'] / prof['wall_ms']:.1f} % of an "
              f"evaluate under the profiler; peak {peak:.2f} GiB at batch "
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
    return launches, by_mode


def bench_phase(smi):
    """tools/bench.py's JSON line in each dtype (float32, then bench.py's
    own bfloat16), beside the card's name and power limit."""
    from densematchingbenchmark_tpu_torch.tools import bench
    for dtype in ("float32", "bfloat16"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            record = bench.main(["--dtype", dtype])
        assert record["value"] > 0 and json.loads(out.getvalue()) == record
        assert record["metric"] == bench.metric_name(dtype), record
        print(f"bench (tools/bench.py --dtype {dtype}): "
              f"{json.dumps(record)}; {smi}")
        torch.cuda.empty_cache()


def profile_phase(models, name="PSMNet/scene_flow_f32"):
    """The forward of each eval mode, and one training step of ``name``,
    by kernel (in float32 also the step with cudnn.benchmark)."""
    from densematchingbenchmark_tpu_torch.configs import get_config
    from densematchingbenchmark_tpu_torch.losses import make_loss_evaluator
    from densematchingbenchmark_tpu_torch.models import build_model
    from densematchingbenchmark_tpu_torch.trainer import (TrainState,
                                                          build_optimizer,
                                                          make_train_step)
    x = torch.randn((1, *PADDED, 3), device="cuda")
    for model in models:
        fused = model.module.fused_upsample_argmin
        device_profile(f"{name} forward fused_upsample_argmin={fused}",
                       lambda: model.forward(x, x))
    cfg = get_config(name)
    crop = cfg["data"]["train"]["input_shape"]
    batch = small_batch(cfg, crop, (crop[0] + 32, crop[1] + 64), 192, "cuda")
    module = build_model(cfg, torch.Generator().manual_seed(0)).cuda()
    state = TrainState.create(module, build_optimizer(cfg, module, 10)[0], 1)
    step = make_train_step(make_loss_evaluator(cfg["model"]["losses"]))
    label = f"{name} train step {TRAIN_BATCH}x{crop[0]}x{crop[1]}"
    device_profile(label, lambda: step(state, batch), top=24, convs=12)
    if cfg["model"]["dtype"] != "float32":
        return
    # the same step with cuDNN's algorithms chosen by timing each shape
    # instead of by its heuristics, to see what the library's choice costs
    torch.backends.cudnn.benchmark = True
    device_profile(f"{label}, cudnn.benchmark", lambda: step(state, batch),
                   top=8)
    torch.backends.cudnn.benchmark = False


def check_bf16_trunk(gen, smi):
    """K4's bfloat16 (wgmma) route at pack 1 at the four trunk shapes of the
    384x1248 forward, at batch 1 and at the eval batch 4, as
    tools/bench_trunk_conv.measure_shape measures it: the eval unit's call
    (a bfloat16 ConvUnit in eval, its operands kept: one launch) and the
    per-call route conv3d_packed_s1(x, kernel, scale, bias) that training
    takes (ReLU on and off) against conv3d_packed_s1_plain within
    BF16_STEP (plus CONV_RTOL); the unit's call by one call and over 20 in
    a row, the kernel alone on prepared operands chained, the per-call
    route by one call and chained, cuDNN's bfloat16 F.conv3d + affine +
    ReLU by one call and chained, the plain version and the bound at the
    tensor cores' rate; with --profile the kernel's device time in the
    unit's call and the call's launches. Returns the row of the batch-1
    forward (13 launches)."""
    from densematchingbenchmark_tpu_torch.tools.bench_trunk_conv import (
        measure_shape)
    profile = "--profile" in sys.argv[1:]
    rows = {}
    for batch in (1, EVAL_BATCH):
        for cin, cout, dhw, per_fwd in CONV_SHAPES:
            # asserts each result within (1e-4 + BF16_STEP) of max|plain|
            r = measure_shape(batch, cin, cout, dhw, gen, profile)
            b_ms = r["bound_ms"]
            dev = (f", kernel device {r['kernel_device_ms']:.4f} (profiler; "
                   f"{r['unit_launches']:.0f} launches a unit call)"
                   if profile else "")
            print(f"K4 bf16 pack 1 (trunk) {cin}->{cout} {batch}x"
                  f"{'x'.join(map(str, dhw))} (x{per_fwd}/fwd): eval unit "
                  f"{r['unit_ms']:.3f} ms, chained {r['unit_chained_ms']:.3f}; "
                  f"kernel alone chained {r['kernel_chained_ms']:.3f}{dev}; "
                  f"per-call route {r['route_ms']:.3f}, chained "
                  f"{r['route_chained_ms']:.3f}; F.conv3d bf16+affine+ReLU "
                  f"{r['cudnn_ms']:.3f}, chained {r['cudnn_chained_ms']:.3f}; "
                  f"plain {r['plain_ms']:.3f}; bound {b_ms:.4f} "
                  f"({r['bound_by']}, {100 * b_ms / r['kernel_chained_ms']:.1f}"
                  f"% of the kernel chained), max_abs_err "
                  f"{r['max_abs_err']:.3g}")
            rows.setdefault(batch, []).append((per_fwd, r))
            torch.cuda.empty_cache()
    for batch, rr in rows.items():
        total = {k: sum(n * r[k] for n, r in rr) for k in rr[0][1]
                 if k.endswith("_ms")}
        print(f"K4 bf16 pack 1 (trunk), a forward at batch {batch} (13 "
              "launches): " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in total.items())
              + f"; {smi}")
        if batch == 1:
            row = {"unit": "per forward (13 launches at the 4 trunk shapes, "
                           "384x1248 batch 1): the eval unit's call",
                   "max_abs_err": max(r["max_abs_err"] for rr in
                                      rows.values() for _, r in rr),
                   "ms": total["unit_ms"],
                   "chained_ms": total["unit_chained_ms"],
                   "kernel_chained_ms": total["kernel_chained_ms"],
                   "route_ms": total["route_ms"],
                   "plain_ms": total["plain_ms"],
                   "library_ms": total["cudnn_ms"],
                   "bound_ms": total["bound_ms"],
                   "bound_by": max(rr, key=lambda x: x[0] * x[1][
                       "bound_ms"])[1]["bound_by"]}
    return row


def check_bf16_regression(gen):
    """K2 (forward at the eval volume, forward and backward at the training
    one) and K3 on bfloat16 costs, as the bfloat16 model hands them over,
    against their plain versions on the same values: float32 disparities
    within ARGMIN_ATOL; K2's gradient, written in the cost's bfloat16,
    within ARGMIN_GRAD_RTOL + BF16_STEP of its largest value; K2's forward
    time on the bfloat16 volume."""
    from densematchingbenchmark_tpu_torch.ops.cost_volume import (
        disp_sample_values)
    from densematchingbenchmark_tpu_torch.ops.cuda import (
        fused_soft_argmin, fused_soft_argmin_backward,
        fused_upsample_soft_argmin, soft_argmin_plain,
        upsample_soft_argmin_plain)
    from densematchingbenchmark_tpu_torch.ops.cuda.soft_argmin_kernel import (
        _forward)
    d = ARGMIN_SHAPE[1]
    vals = torch.as_tensor(disp_sample_values(d), device="cuda")
    cost = (torch.randn(ARGMIN_SHAPE, device="cuda", generator=gen)
            * 3).bfloat16()
    got = fused_soft_argmin(cost, d)
    e_fwd = (got - soft_argmin_plain(cost, vals)).abs().max().item()
    assert got.dtype == torch.float32 and e_fwd <= ARGMIN_ATOL, e_fwd
    ms = time_ms(lambda: fused_soft_argmin(cost, d))
    chain = chained_ms(lambda: fused_soft_argmin(cost, d))
    b_ms = bound_ms(6 * cost.numel(), 2 * cost.numel()
                    + 4 * (d + cost[:, 0].numel()))[0]
    barriers = soft_argmin_barriers(cost, vals)
    del cost
    train = (torch.randn(TRAIN_ARGMIN_SHAPE, device="cuda", generator=gen)
             * 3).bfloat16().requires_grad_()
    g = torch.randn((*TRAIN_ARGMIN_SHAPE[:1], *TRAIN_ARGMIN_SHAPE[2:], 1),
                    device="cuda", generator=gen)
    out = fused_soft_argmin(train, d)
    plain_out = soft_argmin_plain(train, vals)
    e_train = (out - plain_out).abs().max().item()
    assert e_train <= ARGMIN_ATOL, e_train
    (got,) = torch.autograd.grad(out, train, g, retain_graph=True)
    (want,) = torch.autograd.grad(plain_out, train, g)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16, got.dtype
    e_bwd = (got.float() - want.float()).abs().max().item()
    tol = (ARGMIN_GRAD_RTOL + BF16_STEP) * want.float().abs().max().item()
    assert e_bwd <= tol, (e_bwd, tol)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, train, g,
                                                 retain_graph=True))
    # the backward kernel alone on the bfloat16 cost, as the float32 row
    # times it: bound by its bytes, the cost read and its gradient written
    # in bfloat16, the per-pixel float32 terms (out, max, sum, gradient)
    # and the sample values
    c = train.detach()
    k_out, m, l = _forward(c, vals, 1.0)
    call = lambda: fused_soft_argmin_backward(c, vals, 1.0, k_out, m, l, g)
    k_ms, k_chain = time_ms(call), chained_ms(call)
    b, _, h, w = TRAIN_ARGMIN_SHAPE
    k_bound, k_by = bound_ms(7 * c.numel(),
                             2 * 2 * c.numel() + 4 * (4 * b * h * w + d))
    del train, out, plain_out, got, want, c, k_out, m, l
    out_d, out_h, out_w = UPSAMPLE_OUT
    low = (torch.randn(UPSAMPLE_LOW, device="cuda", generator=gen)
           * 3).bfloat16()
    got = fused_upsample_soft_argmin(low, out_d, out_h, out_w)
    e_k3 = (got - upsample_soft_argmin_plain(low, out_d, out_h, out_w,
                                             vals)).abs().max().item()
    assert got.dtype == torch.float32 and e_k3 <= ARGMIN_ATOL, e_k3
    k3_ms = time_ms(lambda: fused_upsample_soft_argmin(low, out_d, out_h,
                                                       out_w))
    print(f"bf16 costs: K2 {list(ARGMIN_SHAPE)} max_abs_err {e_fwd:.3g} px, "
          f"{ms:.3f} ms, chained {chain:.3f} (bound {b_ms:.3f}, bytes, the "
          f"volume in bfloat16), {barriers}; K2 {list(TRAIN_ARGMIN_SHAPE)} "
          f"forward {e_train:.3g} px, backward (autograd through the "
          f"kernel) {bwd_ms:.3f} ms, max_abs_err {e_bwd:.3g} (tolerance "
          f"{tol:.3g}, gradient in bfloat16), the backward kernel alone "
          f"{k_ms:.3f} ms, chained {k_chain:.3f} (bound {k_bound:.3f}, "
          f"{k_by}, {100 * k_bound / k_chain:.1f}% chained); K3 "
          f"{list(UPSAMPLE_LOW)} max_abs_err {e_k3:.3g} px, {k3_ms:.3f} ms "
          f"(the low-resolution cost promoted to float32 first)")
    return {"bf16_ms": k_ms, "bf16_chained_ms": k_chain,
            "bf16_bound_ms": k_bound}


def run_bf16_mode(fused, pairs, f32_disps, smi):
    """init_model("PSMNet/scene_flow_bf16") in one eval mode and
    inference_stereo over ``pairs``, with its launches asserted (K4's
    bfloat16 route 13 a forward, K1 none, K2 or K3 3) and the trunk's K4
    operands built in the first frame only (13, then none); the disparities
    against the float32 model's of the same seed (``f32_disps``); the
    forward's time and the peak memory; the forward under the sync guard.
    Returns (model, counts)."""
    from densematchingbenchmark_tpu_torch.apis import (inference_stereo,
                                                       init_model)
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    model = init_model("PSMNet/scene_flow_bf16", seed=0,
                       **{"model.eval.fused_upsample_argmin": fused})
    assert model.cfg["model"]["dtype"] == "bfloat16"
    from densematchingbenchmark_tpu_torch.models.layers import ConvUnit
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    # the first frame builds the 13 trunk units' K4 operands, the later
    # frames none
    builds = ConvUnit.operand_builds
    results = inference_stereo(model, pairs[:1], pad_to_shape=PADDED)
    first = ConvUnit.operand_builds - builds
    results += inference_stereo(model, pairs[1:], pad_to_shape=PADDED)
    later = ConvUnit.operand_builds - builds - first
    assert (first, later) == (13, 0), (first, later)
    torch.cuda.synchronize()
    counts, bf16 = kernels.launch_counts(), kernels.bf16_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = len(pairs)
    regress = "fused_upsample_soft_argmin" if fused else "fused_soft_argmin"
    want = {k: 0 for k in counts}
    want["conv3d_packed_s1"], want[regress] = 13 * n, 3 * n
    assert counts == want, counts
    assert bf16 == {"conv3d_packed_s1": 13 * n, "conv3d_packed_s1_v2": 0}, \
        bf16
    gaps = []
    for r, ref in zip(results, f32_disps):
        assert len(r["disps"]) == 3
        for d, f in zip(r["disps"], ref):
            assert d.shape == (1, *IMAGE, 1) and d.dtype == np.float32
            assert np.isfinite(d).all()
            gaps.append((float(np.abs(d - f).mean()),
                         float(np.abs(d - f).max())))
    mean_gap = max(g[0] for g in gaps)
    max_gap = max(g[1] for g in gaps)
    x = torch.randn((1, *PADDED, 3), device="cuda")
    ms = time_ms(lambda: model.forward(x, x), FORWARD_REPS)
    print(f"slice bf16 fused_upsample_argmin={fused}: forward {ms:.2f} ms "
          f"(median of {FORWARD_REPS}, 1x{PADDED[0]}x{PADDED[1]}), peak "
          f"{peak:.2f} GiB, launches over {n} pairs {counts} (bf16 {bf16}), "
          f"K4 operands built {first} in the first frame, {later} after; "
          f"vs float32, same seed: mean |gap| up to {mean_gap:.4f} px "
          f"(tolerance {BF16_GAP_ATOL}), largest {max_gap:.4f} px; {smi}")
    assert mean_gap <= BF16_GAP_ATOL, gaps
    guarded(f"PSMNet/scene_flow_bf16 eval forward at {PADDED}, "
            f"fused_upsample_argmin={fused}", lambda: model.forward(x, x))
    return model, counts


def bf16_slice_phase(pairs, f32_disps, smi):
    """The bfloat16 forward at full width in both eval modes (with
    ``--profile``, by kernel beside a bfloat16 train step); returns the
    launch counts of its inference_stereo runs."""
    launches, models = None, []
    for fused, ref in zip((False, True), f32_disps):
        model, counts = run_bf16_mode(fused, pairs, ref, smi)
        models.append(model)
        launches = ({k: launches[k] + v for k, v in counts.items()}
                    if launches else counts)
    if "--profile" in sys.argv[1:]:
        profile_phase(models, "PSMNet/scene_flow_bf16")
    return launches


def eval_dataset(cfg, root, ann):
    """The KITTI-2015-layout test split at ``root`` through the eval
    transform, padded to PADDED."""
    from densematchingbenchmark_tpu_torch.data import (build_dataset,
                                                       transforms)
    test_cfg = dict(cfg["data"], data_root=root, test=dict(
        cfg["data"]["test"], annfile=ann, use_right_disp=True))
    return build_dataset(test_cfg, "test", transforms.make_eval_transform(
        PADDED, cfg["data"]["mean"], cfg["data"]["std"]))


def bf16_eval_phase(smi, root, ann, f32_results):
    """tools/test.py on PSMNet/kitti_2015_bf16 over the eval phase's six
    pairs at batch 4, in both eval modes: launches asserted (K4's bfloat16
    route 13 a batch, K1 none), every metric finite, each EPE within
    BF16_GAP_ATOL of the float32 eval's (|EPE_a - EPE_b| <= mean |a - b|),
    the per-batch work under the sync guard; the eval step's ms a sample
    at batch 4 and 1 and the peak memory. Returns the launch counts."""
    from densematchingbenchmark_tpu_torch.apis import init_model
    from densematchingbenchmark_tpu_torch.configs import get_config
    from densematchingbenchmark_tpu_torch.data import collate
    from densematchingbenchmark_tpu_torch.evaluation import eval_loop
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    from densematchingbenchmark_tpu_torch.tools import test as test_tool
    launches = None
    for fused in (False, True):
        over = [f"model.eval.fused_upsample_argmin={fused}",
                "data.test.use_right_disp=True",
                f"data.test.input_shape={PADDED}"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        results, n = test_tool.main([
            "--config", BF16_EVAL_CONFIG, "--work-dir",
            os.path.join(root, "work_bf16"), "--data-root", root,
            "--annfile", ann, "--override", *over])
        torch.cuda.synchronize()
        counts, bf16 = kernels.launch_counts(), kernels.bf16_launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        regress = ("fused_upsample_soft_argmin" if fused
                   else "fused_soft_argmin")
        want = {k: 0 for k in counts}
        want["conv3d_packed_s1"] = 13 * EVAL_BATCHES
        want[regress] = 3 * EVAL_BATCHES
        assert n == len(EVAL_SIZES) and counts == want, (n, counts)
        assert bf16["conv3d_packed_s1"] == 13 * EVAL_BATCHES, bf16
        launches = ({k: launches[k] + v for k, v in counts.items()}
                    if launches else counts)
        assert set(results) == set(f32_results[fused])
        assert all(np.isfinite(v) for v in results.values()), results
        epe_gap = max(abs(results[k] - f32_results[fused][k])
                      for k in results if k.endswith("epe"))
        assert epe_gap <= BF16_GAP_ATOL, (fused, epe_gap)

        cfg = get_config(BF16_EVAL_CONFIG, **{
            "model.eval.fused_upsample_argmin": fused})
        model = init_model(cfg, seed=0)
        ds = eval_dataset(cfg, root, ann)
        ecfg, ids = cfg["model"]["eval"], cfg["eval_disparity_id"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending, count = eval_loop.eval_batches(model.module, ds, ecfg,
                                                    ids)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        compare_metrics(eval_loop.average_metrics(pending, count), results,
                        f"bf16 fused={fused} guarded")
        if "--profile" in sys.argv[1:]:
            device_profile(f"evaluate {BF16_EVAL_CONFIG} fused_upsample_"
                           f"argmin={fused}, {n} samples", lambda: (
                               eval_loop.evaluate(model.module, ds, ecfg,
                                                  ids)), reps=1)
        step = eval_loop.make_eval_metrics_step(
            model.module, ecfg["lower_bound"], ecfg["upper_bound"], ids,
            ecfg["eval_occlusion"])
        b4 = eval_loop.to_device(collate([ds[i] for i in range(
            EVAL_BATCH)]), model.device)
        b1 = {k: v[:1] for k, v in b4.items()}
        ms4 = time_ms(lambda: step(b4), 3) / EVAL_BATCH
        ms1 = time_ms(lambda: step(b1), 3)
        print(f"eval {BF16_EVAL_CONFIG} fused_upsample_argmin={fused}: {n} "
              f"samples, batches of {EVAL_BATCH}; launches {counts} (bf16 "
              f"{bf16}); disp_0 EPE {results['disp_0/epe']:.4f} px (float32 "
              f"{f32_results[fused]['disp_0/epe']:.4f}; largest EPE gap "
              f"{epe_gap:.4f}, tolerance {BF16_GAP_ATOL}), 3px "
              f"{results['disp_0/3px']:.4f} %; eval step {ms4:.2f} ms a "
              f"sample at batch {EVAL_BATCH}, {ms1:.2f} at batch 1 (device, "
              f"CUDA events); peak {peak:.2f} GiB at batch {EVAL_BATCH}; no "
              f"synchronising call per batch; {smi}")
        del model, b4, b1, step
        torch.cuda.empty_cache()
    return launches


def damp_bn(module, seed):
    """Give every BatchNorm of ``module`` (on the CPU) random parameters
    and running statistics from ``seed``, drawn as the CPU tests draw them
    against JAX (tests/test_torch_psmnet.py: scale 0.7-1.1, var 0.9-1.4,
    bias and mean 0.1 N(0, 1)); returns the module. With gains under 1 a
    random network's costs stay moderate, and its disparities move by
    hundredths of a pixel under bfloat16 rounding; with the default BN
    (identity) they move by tenths, wherever the rounding happens."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=gen) * 0.4 + 0.7)
                m.running_var.copy_(torch.rand(n, generator=gen) * 0.5 + 0.9)
                m.bias.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
    return module


def bf16_small_phase(smi):
    """A small bfloat16 model on the card and on the CPU (the plain
    versions) from the same weights (BN as the CPU tests draw it,
    ``damp_bn``) and inputs: the disparities of both eval modes within
    BF16_CPU_ATOL px mean, and one train step's losses within
    BF16_LOSS_RTOL, its gradients float32 and finite. For the record, the
    same with the default BN beside the CPU's own bfloat16-vs-float32
    gap."""
    from densematchingbenchmark_tpu_torch.apis import (StereoModel,
                                                       inference_stereo,
                                                       init_model)
    from densematchingbenchmark_tpu_torch.configs import get_config
    from densematchingbenchmark_tpu_torch.models import build_model
    rng = np.random.RandomState(2)
    pair = random_pairs(rng, 1, SMALL_IMAGE)
    pad = tuple(-(-s // 32) * 32 for s in SMALL_IMAGE)

    def disps(model):
        return inference_stereo(model, pair, pad_to_shape=pad)[0]["disps"]

    def gap(a, b):
        return max(float(np.abs(x - y).mean()) for x, y in zip(a, b))

    gaps, default = {}, {}
    for fused in (False, True):
        over = dict(SMALL, **{"model.eval.fused_upsample_argmin": fused})
        cpu = init_model("PSMNet/scene_flow_bf16", device="cpu", seed=3,
                         **over)
        card = StereoModel(cpu.cfg, copy.deepcopy(cpu.module).cuda(),
                           torch.device("cuda"))
        f32 = init_model("PSMNet/scene_flow_f32", device="cpu", seed=3,
                         **over)
        want = disps(cpu)
        default[fused] = (gap(disps(card), want), gap(want, disps(f32)))
        damp_bn(cpu.module, 3)
        card.module = copy.deepcopy(cpu.module).cuda()
        got, want = disps(card), disps(cpu)
        assert all(np.isfinite(g).all() for g in got)
        gaps[fused] = gap(got, want)
        assert gaps[fused] <= BF16_CPU_ATOL, (fused, gaps)
    cfg = get_config("PSMNet/scene_flow_bf16", **SMALL)
    cpu = damp_bn(build_model(cfg, torch.Generator().manual_seed(1)), 1)
    card = copy.deepcopy(cpu).cuda()
    batch = small_batch(cfg, (64, 128), (96, 192), 24, "cuda")
    g_card, m_card, p_card, _ = grads_and_step(card, batch, cfg)
    _, m_cpu, _, _ = grads_and_step(
        cpu, {k: v.cpu() for k, v in batch.items()}, cfg)
    loss_err = max(abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k])
                   for k in m_cpu if k != "grad_norm")
    assert loss_err <= BF16_LOSS_RTOL, (m_card, m_cpu)
    for n, g in g_card.items():
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), n
        assert p_card[n].dtype == torch.float32, n
    print(f"bf16 small model, card vs CPU at {SMALL['model.max_disp']} "
          f"disps, {SMALL_IMAGE}: disparities mean |gap| {gaps[False]:.4f} "
          f"px plain, {gaps[True]:.4f} fused (tolerance {BF16_CPU_ATOL}); "
          f"with the default BN {default[False][0]:.4f} / "
          f"{default[True][0]:.4f} px, where the CPU's own bf16 and float32 "
          f"lie {default[False][1]:.4f} / {default[True][1]:.4f} px apart; "
          f"one train step 2x64x128: losses rel err {loss_err:.3g} "
          f"(tolerance {BF16_LOSS_RTOL}), grad_norm "
          f"{m_card['grad_norm']:.4f} vs {m_cpu['grad_norm']:.4f}; "
          f"gradients and parameters float32; {smi}")


# AcfNet (adaptive and uniform) at full width: max_disp 192, trunk in_planes
# 64, cmn in_planes 192. Its 13 trunk units are PSMNet's, the 7 outside the
# hourglasses with a conv bias folded into the kernel's shift (ConvUnit_0
# 64->32, ConvUnit_1-6 32->32, all at D/4 x H/4 x W/4 = 48x96x312 of a
# 384x1248 frame); the three classified costs are upsampled by learned
# transposed convs to full-resolution volumes that K2 regresses.
ACF_CONFIG = "AcfNet/scene_flow_adaptive"
ACF_EVAL_CONFIG = "AcfNet/kitti_2015_adaptive"
BIAS_SHAPES = ((64, 32, (48, 96, 312)), (32, 32, (48, 96, 312)))
ACF_SMALL = {"model.max_disp": 32,
             "model.cost_processor.cost_computation.max_disp": 8,
             "model.cost_processor.cost_aggregator.max_disp": 32,
             "model.disp_predictor.max_disp": 32,
             "model.losses.l1_loss.max_disp": 32,
             "model.losses.focal_loss.max_disp": 32,
             "model.cmn.in_planes": 32,
             "model.cmn.losses.nll_loss.max_disp": 32,
             "data.batch_size_per_device": 2}
# the sparsification pass of tools/test.py: one batch-1 forward a sample
ACF_SPARS = len(EVAL_SIZES)


def check_bias_epilogue(gen):
    """A biased trunk unit in eval at AcfNet's two biased shapes: K1
    (float32) and K4's bfloat16 route on the unit's kept operands, whose
    shift folds the conv bias (conv_bias * inv + bn_bias - mean * inv),
    against the plain version on the same folded operands (CONV_RTOL;
    BF16_STEP besides in bfloat16) and against the unfused conv + bias,
    BN and ReLU in float32; after an in-place change of the bias alone the
    kept operands are built again (one build) and give the new result.
    Returns {dtype: largest error against the plain version}."""
    from densematchingbenchmark_tpu_torch.models.layers import ConvUnit
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    from densematchingbenchmark_tpu_torch.ops.cuda import (
        conv3d_packed_s1_plain, conv3d_plain)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        for cin, cout, dhw in BIAS_SHAPES:
            unit = ConvUnit(cin, cout, 3, 1, 1, dims=3, bias=True,
                            dtype=dtype).cuda().eval()
            conv, bn = unit.Conv_0, unit.BatchNorm_0
            with torch.no_grad():
                conv.weight.copy_(torch.randn(
                    conv.weight.shape, device="cuda", generator=gen)
                    * (27 * cin) ** -0.5)
                conv.bias.copy_(torch.randn(cout, device="cuda",
                                            generator=gen) * 0.5)
                bn.weight.copy_(torch.rand(cout, device="cuda",
                                           generator=gen) * 0.4 + 0.7)
                bn.bias.copy_(torch.randn(cout, device="cuda",
                                          generator=gen) * 0.1)
                bn.running_mean.copy_(torch.randn(cout, device="cuda",
                                                  generator=gen) * 0.1)
                bn.running_var.copy_(torch.rand(cout, device="cuda",
                                                generator=gen) * 0.5 + 0.9)
            x = torch.randn((1, *dhw, cin), device="cuda",
                            generator=gen).to(dtype)
            for change in (False, True):
                if change:                      # the bias alone
                    with torch.no_grad():
                        conv.bias.add_(0.25)
                builds = ConvUnit.operand_builds
                kernels.reset_launch_counts()
                with torch.no_grad():
                    got = unit(x)
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
                bf16 = kernels.bf16_launch_counts()["conv3d_packed_s1"]
                if f32:
                    assert counts["fused_conv3d"] == 1 and bf16 == 0, counts
                else:
                    assert counts["conv3d_packed_s1"] == bf16 == 1, counts
                assert ConvUnit.operand_builds == builds + 1
                with torch.no_grad():
                    inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
                    shift = conv.bias * inv + bn.bias - bn.running_mean * inv
                    kernel = conv.weight.permute(2, 3, 4, 1, 0).to(dtype)
                    want = (conv3d_plain(x, kernel, inv, shift, True) if f32
                            else conv3d_packed_s1_plain(x, kernel, inv,
                                                        shift, 1, True))
                    unfused = torch.relu(F.batch_norm(
                        F.conv3d(x.float().movedim(-1, 1),
                                 conv.weight.to(dtype).float(), conv.bias,
                                 padding=1), bn.running_mean,
                        bn.running_var, bn.weight, bn.bias, False, 0.0,
                        bn.eps)).movedim(1, -1)
                top = want.float().abs().max().item()
                err = (got.float() - want.float()).abs().max().item()
                tol = (CONV_RTOL if f32 else CONV_RTOL + BF16_STEP) * top
                assert err <= tol, (dtype, cin, cout, change, err, tol)
                err_unfused = (got.float() - unfused).abs().max().item()
                assert err_unfused <= tol, (dtype, cin, cout, err_unfused)
                errs[dtype] = max(errs.get(dtype, 0.0), err)
            print(f"bias epilogue {'K1' if f32 else 'K4 bf16'} {cin}->{cout} "
                  f"{'x'.join(map(str, dhw))}: conv bias folded into the "
                  f"shift, max_abs_err {err:.3g} against the plain version "
                  f"(tolerance {tol:.3g}), {err_unfused:.3g} against the "
                  f"unfused conv + bias, BN, ReLU; after an in-place change "
                  f"of the bias one operand build and the new result")
            del unit, x, got, want, unfused
    torch.cuda.empty_cache()
    return errs


def padded_input(model, pair, pad=PADDED):
    """One pair through inference_stereo's preprocessing, on the card."""
    from densematchingbenchmark_tpu_torch.data import transforms
    data = model.cfg["data"]
    sample = transforms.normalize(transforms.pad_to(
        {k: pair[k].astype(np.float32) for k in pair}, pad),
        data["mean"], data["std"])
    return [torch.from_numpy(np.ascontiguousarray(sample[k]))[None].cuda()
            for k in ("leftImage", "rightImage")]


def acf_forward(name, pairs):
    """init_model(name, seed 0) + inference_stereo over ``pairs`` padded
    to PADDED, with the launches asserted (per forward K1 13 in float32 or
    K4's bfloat16 route 13, K2 3, K3 none); confidences in [0, 1] and
    variances 1 * (1 - conf) + 1 from one forward; the forward's ms.
    Returns (model, disparities, counts, bf16 counts, ms, peak GiB, the
    share of each confidence map strictly inside (0, 1))."""
    from densematchingbenchmark_tpu_torch.apis import (inference_stereo,
                                                       init_model)
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    model = init_model(name, seed=0)
    f32 = model.cfg["model"]["dtype"] == "float32"
    n = len(pairs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    results = inference_stereo(model, pairs, pad_to_shape=PADDED)
    torch.cuda.synchronize()
    counts, bf16 = kernels.launch_counts(), kernels.bf16_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert counts == {"fused_conv3d": 13 * n if f32 else 0,
                      "fused_soft_argmin": 3 * n,
                      "fused_soft_argmin_backward": 0,
                      "fused_upsample_soft_argmin": 0,
                      "conv3d_packed_s1": 0 if f32 else 13 * n,
                      "conv3d_packed_s1_v2": 0}, counts
    assert bf16["conv3d_packed_s1"] == (0 if f32 else 13 * n), bf16
    disps = [r["disps"] for r in results]
    for ds in disps:
        assert len(ds) == 3
        for d in ds:
            assert d.shape == (1, *IMAGE, 1) and np.isfinite(d).all()
            # an expectation over the samples 0..191, float32 sums
            assert d.min() >= -1e-3 and d.max() <= 191 + 1e-3, (d.min(),
                                                                 d.max())
    left, right = padded_input(model, pairs[0])
    out = model.forward(left, right)
    inside = []
    for c, v in zip(out["confs"], out["variances"]):
        assert c.shape == (1, *PADDED, 1) and c.dtype == torch.float32
        # sigmoid in float32: 0 and 1 only where it saturates
        assert bool(((c >= 0) & (c <= 1)).all()), (c.min(), c.max())
        assert torch.equal(v, 1.0 * (1.0 - c) + 1.0)
        inside.append(((c > 0) & (c < 1)).float().mean().item())
    ms = time_ms(lambda: model.forward(left, right), FORWARD_REPS)
    return model, disps, counts, bf16, ms, peak, inside


def acf_slice_phase(smi):
    """AcfNet adaptive inference at full width in float32 and bfloat16 on
    three random 375x1242 pairs, the bfloat16-vs-float32 gap on the same
    weights, then a small model on the card against the CPU. Returns the
    launch counts of each dtype's run."""
    from densematchingbenchmark_tpu_torch.apis import (StereoModel,
                                                       inference_stereo,
                                                       init_model)
    rng = np.random.RandomState(3)
    pairs = random_pairs(rng, PAIRS, IMAGE)
    runs = {}
    for suffix in ("_f32", "_bf16"):
        model, disps, counts, bf16, ms, peak, inside = acf_forward(
            ACF_CONFIG + suffix, pairs)
        runs[suffix] = (disps, counts)
        n_params = sum(p.numel() for p in model.module.parameters())
        print(f"acfnet {ACF_CONFIG + suffix} ({n_params / 1e6:.3f} M "
              f"params): inference_stereo over {PAIRS} pairs {IMAGE} padded "
              f"to {PADDED}, disparities finite in [0, 191], confidences in "
              f"[0, 1] ({', '.join(f'{100 * x:.2f}' for x in inside)} % of "
              f"the pixels strictly inside); launches {counts} (bf16 route "
              f"{bf16}); forward "
              f"{ms:.2f} ms (median of {FORWARD_REPS}, CUDA events), peak "
              f"{peak:.2f} GiB at batch 1; {smi}")
        del model
        torch.cuda.empty_cache()
    gaps = [float(np.abs(a - b).mean()) for da, db in zip(
        runs["_f32"][0], runs["_bf16"][0]) for a, b in zip(da, db)]
    print(f"acfnet: bf16 vs float32 on the same weights (seed 0): mean "
          f"|gap| {min(gaps):.4f}-{max(gaps):.4f} px over the pairs' three "
          f"disparities (PSMNet's measured 1.21-1.96, BF16_GAP_ATOL "
          f"{BF16_GAP_ATOL})")
    assert np.isfinite(gaps).all()

    # a small model on the card against the same weights on the CPU
    small = random_pairs(rng, 1, SMALL_IMAGE)
    pad = tuple(-(-s // 32) * 32 for s in SMALL_IMAGE)
    report = []
    for suffix, atol in (("_f32", CPU_ATOL), ("_bf16", BF16_CPU_ATOL)):
        cpu = init_model(ACF_CONFIG + suffix, device="cpu", seed=4,
                         **ACF_SMALL)
        damp_bn(cpu.module, 4)
        card = StereoModel(cpu.cfg, copy.deepcopy(cpu.module).cuda(),
                           torch.device("cuda"))
        want = inference_stereo(cpu, small, pad_to_shape=pad)[0]["disps"]
        got = inference_stereo(card, small, pad_to_shape=pad)[0]["disps"]
        if suffix == "_f32":
            err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        else:
            err = max(float(np.abs(g - w).mean()) for g, w in zip(got, want))
        assert err <= atol, (suffix, err)
        report.append(f"{suffix[1:]} {err:.4g} px "
                      f"({'max' if suffix == '_f32' else 'mean'}, "
                      f"tolerance {atol})")
    print(f"acfnet small model ({ACF_SMALL['model.max_disp']} disps, "
          f"{SMALL_IMAGE}), card vs CPU plain versions: " + ", ".join(report))
    return runs["_f32"][1], runs["_bf16"][1]


def acf_eval_phase(smi, root, ann):
    """tools/test.main on AcfNet/kitti_2015_adaptive_f32 over the
    KITTI-layout pairs at batch 4 and at batch 1 (metrics within the eval
    tolerances of each other), then on _bf16 at batch 4 (each EPE within
    BF16_GAP_ATOL of float32's): the metric table, then the sparsification
    pass (a batch-1 forward a sample) with its est / oracle / random rows
    printed and finite; launches asserted. The eval step's ms a sample and
    its peak at batch 4 and at batch 1. Returns the float32 and bfloat16
    launch counts."""
    from densematchingbenchmark_tpu_torch.apis import init_model
    from densematchingbenchmark_tpu_torch.configs import get_config
    from densematchingbenchmark_tpu_torch.data import collate
    from densematchingbenchmark_tpu_torch.evaluation import eval_loop
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    from densematchingbenchmark_tpu_torch.tools import test as test_tool
    launches = {"_f32": None, "_bf16": None}
    by_run = {}
    for suffix, batch in (("_f32", EVAL_BATCH), ("_f32", 1),
                          ("_bf16", EVAL_BATCH)):
        name = ACF_EVAL_CONFIG + suffix
        batches = -(-len(EVAL_SIZES) // batch)
        over = ["data.test.use_right_disp=True",
                f"data.test.input_shape={PADDED}",
                f"model.eval.batch_size={batch}"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            results, n = test_tool.main([
                "--config", name, "--work-dir", os.path.join(root, "acf"),
                "--data-root", root, "--annfile", ann, "--override", *over])
        torch.cuda.synchronize()
        counts, bf16 = kernels.launch_counts(), kernels.bf16_launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        trunk = 13 * (batches + ACF_SPARS)
        f32 = suffix == "_f32"
        assert n == len(EVAL_SIZES) and counts == {
            "fused_conv3d": trunk if f32 else 0,
            "fused_soft_argmin": 3 * (batches + ACF_SPARS),
            "fused_soft_argmin_backward": 0,
            "fused_upsample_soft_argmin": 0,
            "conv3d_packed_s1": 0 if f32 else trunk,
            "conv3d_packed_s1_v2": 0}, (n, counts)
        assert bf16["conv3d_packed_s1"] == (0 if f32 else trunk), bf16
        launches[suffix] = ({k: launches[suffix][k] + v
                             for k, v in counts.items()}
                            if launches[suffix] else counts)
        rows = [line for line in text.getvalue().splitlines()
                if line.split()[:1] in (["est"], ["oracle"], ["random"])]
        assert f"sparsification ({n} samples" in text.getvalue()
        assert [r.split()[0] for r in rows] == ["est", "oracle", "random"]
        assert all(len(r.split()) == 12 for r in rows), rows
        assert all(np.isfinite(v) for v in results.values()), results
        by_run[suffix, batch] = results
        print(f"eval {name} batch {batch}: {n} samples padded to {PADDED}, "
              f"{batches} batches + the sparsification pass ({ACF_SPARS} "
              f"forwards); launches {counts}; disp_0 EPE "
              f"{results['disp_0/epe']:.4f} px, 3px "
              f"{results['disp_0/3px']:.4f} %; peak {peak:.2f} GiB "
              f"(the tool's run); {smi}")
        for r in text.getvalue().splitlines()[-4:]:
            print("  " + r)
    metric = {k: v for k, v in by_run["_f32", EVAL_BATCH].items()
              if not k.startswith("sparsification/")}
    epe, px = compare_metrics(metric, {
        k: by_run["_f32", 1][k] for k in metric}, "acfnet batch 4 vs 1")
    sp = max(abs(by_run["_f32", EVAL_BATCH][k] - by_run["_f32", 1][k])
             for k in by_run["_f32", 1] if k.startswith("sparsification/"))
    epe_gap = max(abs(by_run["_bf16", EVAL_BATCH][k] - metric[k])
                  for k in metric if k.endswith("epe"))
    assert epe_gap <= BF16_GAP_ATOL, epe_gap
    print(f"eval {ACF_EVAL_CONFIG}: batch 4 against batch 1 EPE {epe:.3g} "
          f"px, n-px {px:.3g} points (tolerances {EVAL_EPE_ATOL}, "
          f"{EVAL_PX_ATOL}); sparsification rows {sp:.3g} apart (the same "
          f"batch-1 pass); bf16 EPE within {epe_gap:.4f} px of float32's")

    # the eval step (forward + metrics, no confidence fetched) per sample
    # and its peak, at batch 4 and 1
    for suffix in ("_f32", "_bf16"):
        cfg = get_config(ACF_EVAL_CONFIG + suffix)
        model = init_model(cfg, seed=0)
        ds = eval_dataset(cfg, root, ann)
        ecfg, ids = cfg["model"]["eval"], cfg["eval_disparity_id"]
        step = eval_loop.make_eval_metrics_step(
            model.module, ecfg["lower_bound"], ecfg["upper_bound"], ids,
            ecfg["eval_occlusion"])
        b4 = eval_loop.to_device(collate([ds[i] for i in range(
            EVAL_BATCH)]), model.device)
        b1 = {k: v[:1] for k, v in b4.items()}
        peaks = {}
        for b, bt in ((EVAL_BATCH, b4), (1, b1)):
            step(bt)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step(bt)
            torch.cuda.synchronize()
            peaks[b] = torch.cuda.max_memory_allocated() / 2 ** 30
        ms4 = time_ms(lambda: step(b4), 3) / EVAL_BATCH
        ms1 = time_ms(lambda: step(b1), 3)
        print(f"eval step {ACF_EVAL_CONFIG + suffix}: {ms4:.2f} ms a sample "
              f"at batch {EVAL_BATCH}, {ms1:.2f} at batch 1 (device, CUDA "
              f"events); peak {peaks[EVAL_BATCH]:.2f} GiB at batch "
              f"{EVAL_BATCH}, {peaks[1]:.2f} at batch 1; {smi}")
        if "--profile" in sys.argv[1:] and suffix == "_f32":
            device_profile(f"{ACF_EVAL_CONFIG + suffix} eval step batch "
                           f"{EVAL_BATCH}", lambda: step(b4),
                           named=ACF_NAMED)
        del model, step, b4, b1
        torch.cuda.empty_cache()
    return launches["_f32"], launches["_bf16"]


def family_train_phase(smi, name, steps, units=13, argmins=3, keys=None,
                       overrides=None):
    """train_matcher on ``name`` (with ``overrides``) at full width, its
    crop and batch, for ``steps`` steps: launches asserted (a step K4
    ``units``, K2 ``argmins`` forward and as many backward; the bfloat16
    route in bfloat16), the loss and every loss entry finite (``keys``;
    AcfNet's by default), the step's ms (median of steps 2 on, host clock)
    and the peak. Returns the launch counts."""
    from densematchingbenchmark_tpu_torch.configs import get_config
    from densematchingbenchmark_tpu_torch.data import (SyntheticStereoDataset,
                                                       transforms)
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    from densematchingbenchmark_tpu_torch.trainer import train_matcher
    from densematchingbenchmark_tpu_torch.trainer.loop import read_metrics
    cfg = get_config(name, **(overrides or {}))
    bf16 = cfg["model"]["dtype"] == "bfloat16"
    data = cfg["data"]
    crop, batch = data["train"]["input_shape"], data["batch_size_per_device"]
    ds = SyntheticStereoDataset(
        length=batch * (steps + 1), height=crop[0] + 32,
        width=crop[1] + 64, max_disp=cfg["model"]["max_disp"],
        transform=transforms.make_train_transform(crop, data["mean"],
                                                  data["std"]))
    with tempfile.TemporaryDirectory() as work:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        train_matcher(cfg, work, train_dataset=ds, max_steps=steps,
                      log_interval=1)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        bf16_counts = kernels.bf16_launch_counts()
        records = [r for r in read_metrics(work) if "train/loss" in r]
    assert counts == {"fused_conv3d": 0,
                      "fused_soft_argmin": argmins * steps,
                      "fused_soft_argmin_backward": argmins * steps,
                      "fused_upsample_soft_argmin": 0,
                      "conv3d_packed_s1": units * steps,
                      "conv3d_packed_s1_v2": 0}, counts
    assert bf16_counts["conv3d_packed_s1"] == (units * steps if bf16
                                               else 0)
    if keys is None:
        adaptive = "cmn" in cfg["model"]
        keys = [f"{k}_lvl{i}" for i in range(3) for k in (
            ("l1_loss", "stereo_focal_loss", "conf_loss") if adaptive
            else ("l1_loss", "stereo_focal_loss"))]
    keys = ["loss"] + list(keys)
    assert [r["step"] for r in records] == list(range(1, steps + 1))
    for r in records:
        for k in keys:
            assert np.isfinite(r[f"train/{k}"]), (k, r)
    step_ms = float(np.median([r["train/step_ms"]
                               for r in records[1:] or records]))
    which = f"median of steps 2-{steps}" if steps > 1 else "step 1"
    peak = max(r["train/peak_mem_gib"] for r in records)
    first = records[0]
    print(f"train {name}: {batch}x{crop[0]}x{crop[1]}, {steps} steps: "
          f"losses {[round(r['train/loss'], 4) for r in records]}; step 1 "
          + ", ".join(f"{k} {first['train/' + k]:.4f}" for k in keys[1:])
          + f"; step {step_ms:.2f} ms ({which}, host clock), peak "
          f"{peak:.2f} GiB; launches {counts} (bf16 route "
          f"{bf16_counts}); {smi}")
    return counts


def acf_profile_cli_phase():
    """tools/train.main on AcfNet/scene_flow_uniform_f32 with --synthetic
    at 256x512 (batch 1, three samples: one epoch of 3 steps, then the vis
    hook's two synthetic samples) and --profile 2:3: the torch.profiler
    trace of steps 2-3 in <work-dir>/profile, the vis hook's panels.
    Returns the launch counts."""
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    from densematchingbenchmark_tpu_torch.tools import train as train_tool
    with tempfile.TemporaryDirectory() as work:
        kernels.reset_launch_counts()
        train_tool.main(["--config", "AcfNet/scene_flow_uniform_f32",
                         "--work-dir", work, "--synthetic",
                         "--synthetic-shape", "256", "512",
                         "--synthetic-length", "3", "--max-steps", "3",
                         "--log-interval", "1", "--profile", "2:3"])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        traces = os.listdir(os.path.join(work, "profile"))
        size = os.path.getsize(os.path.join(work, "profile", traces[0]))
        vis = sorted(os.listdir(os.path.join(work, "vis")))
    assert traces == ["steps_2_3.pt.trace.json"], traces
    assert vis == ["sample_000", "sample_001"], vis
    # 3 steps, then the vis hook's 2 eval forwards (float32: K1)
    assert counts == {"fused_conv3d": 26, "fused_soft_argmin": 9 + 6,
                      "fused_soft_argmin_backward": 9,
                      "fused_upsample_soft_argmin": 0,
                      "conv3d_packed_s1": 39, "conv3d_packed_s1_v2": 0}, counts
    print(f"tools/train.py --profile 2:3 on AcfNet/scene_flow_uniform_f32 "
          f"(--synthetic 256x512, batch 1, 3 steps): trace {traces[0]} "
          f"({size / 2 ** 20:.1f} MiB), vis panels of 2 samples; launches "
          f"{counts}")
    return counts


# device-time rows named in the AcfNet profiles: the convolution ops
# (forward and backward, their kernels included) of these weight shapes
ACF_NAMED = {
    "learned upsample (ConvTranspose3d 1->1 k8 s4)": [1, 1, 8, 8, 8],
    "ConfHead 3x3 conv (192->64)": [64, 192, 3, 3],
    "ConfHead 1x1 conv (64->1)": [1, 64, 1, 1],
}


def acf_profile_phase():
    """The AcfNet adaptive forward at 384x1248 batch 1 and a train step at
    256x512 batch 3, in float32 and bfloat16, by kernel, with the learned
    upsample's and ConfHead's convolutions named."""
    from densematchingbenchmark_tpu_torch.apis import init_model
    from densematchingbenchmark_tpu_torch.configs import get_config
    from densematchingbenchmark_tpu_torch.losses import make_loss_evaluator
    from densematchingbenchmark_tpu_torch.models import build_model
    from densematchingbenchmark_tpu_torch.trainer import (TrainState,
                                                          build_optimizer,
                                                          make_train_step)
    x = torch.randn((1, *PADDED, 3), device="cuda")
    for suffix in ("_f32", "_bf16"):
        name = ACF_CONFIG + suffix
        model = init_model(name, seed=0)
        device_profile(f"{name} forward 1x{PADDED[0]}x{PADDED[1]}",
                       lambda: model.forward(x, x), named=ACF_NAMED)
        del model
        cfg = get_config(name)
        crop = cfg["data"]["train"]["input_shape"]
        batch = small_batch(cfg, crop, (crop[0] + 32, crop[1] + 64), 192,
                            "cuda")
        module = build_model(cfg, torch.Generator().manual_seed(0)).cuda()
        state = TrainState.create(module, build_optimizer(cfg, module,
                                                          10)[0], 1)
        step = make_train_step(make_loss_evaluator(
            cfg["model"]["losses"],
            cmn_losses_cfg=cfg["model"]["cmn"]["losses"]))
        device_profile(f"{name} train step {TRAIN_BATCH}x{crop[0]}x"
                       f"{crop[1]}", lambda: step(state, batch), top=20,
                       named=ACF_NAMED)
        del module, state, batch
        torch.cuda.empty_cache()


# StereoNet (8x, 2-stage and 4-stage) at full width: max_disp 192, 24 cost
# disparities at 1/8 resolution. Its trunk is 4 biased 32->32 units at
# D/8 x H/8 x W/8 = 24x48x156 of a 384x1248 frame (K1 in float32 eval, K4's
# bfloat16 route in bf16 eval, K4 in training at the 256x512 crop's
# 24x32x64), K2 regresses one float32 cost of 24 disparities (in both
# dtypes: the aggregator returns float32, as JAX's), and the refinement's
# full-resolution 2-D convs are cuDNN's.
STEREO_CONFIG = "StereoNet/scene_flow_8x_4stage"
STEREO_TWO = "StereoNet/scene_flow_8x_2stage"
STEREO_UNITS, STEREO_TRUNK = 4, (24, 48, 156)
STEREO_TRAIN_TRUNK = (24, 32, 64)
# SceneFlow frames (540x960) padded to the config's test shape
STEREO_EVAL_IMAGE, STEREO_EVAL_PAD, STEREO_EVAL_N = (540, 960), (544, 960), 6
STEREO_SMALL = {"model.max_disp": 64,
                "model.cost_processor.cost_computation.max_disp": 8,
                "model.disp_predictor.max_disp": 8,
                "model.losses.l1_loss.max_disp": 64,
                "data.batch_size_per_device": 2}
# A refined disparity in bfloat16 on the card against the CPU: two
# bfloat16 runs that round at other points (cuDNN's convs and the CPU's)
# each carry bfloat16's own error, which a refinement stage adds at the
# scale of its residual (tens of px at random weights). So each refined
# disparity's mean gap is held to STEREO_BF16_NOISE times the CPU's own
# bfloat16-vs-float32 mean gap on the same weights (measured at the small
# model: 0.149 / 0.125 / 0.082 px; the card's first run 0.213 px on the
# best, 1.43x), plus 0.01 px; the initial disparity, the trunk's soft-argmin
# as PSMNet's, within BF16_CPU_ATOL.
STEREO_BF16_NOISE = 2.0
# ... and the card's own bfloat16-vs-float32 mean gap on a refined
# disparity between these multiples of the CPU's (+ 1e-3 px above), the
# rule the CPU tests hold the port's own gap to against JAX's: the lower
# side fails a refinement that ignores bfloat16 (its own gap is then 3 %
# of JAX's at the CPU tests' size)
STEREO_OWN_RANGE = (0.8, 1.25)
# the widths of fault 8: (Ci, Co) of fusable units at widths the kernel
# blocks do not take as they are (GCNet's 128 -> 128, above the bfloat16
# block's Ci of 112; an odd width in both dtypes), and StereoNet's own,
# which both blocks take
FAULT8_WIDTHS = ((128, 128), (65, 64), (32, 32))


def biased_unit(cin, cout, dtype, gen, bias=True, pre_norm=False):
    """A trunk ConvUnit on the card with random weights, conv bias (with
    ``bias``) and BN (scale 0.7-1.1, var 0.9-1.4, bias and mean 0.1 N(0,
    1)); with ``pre_norm`` AnyNet's BN -> ReLU -> conv unit (its BN over
    the Cin input channels)."""
    from densematchingbenchmark_tpu_torch.models.layers import ConvUnit
    unit = ConvUnit(cin, cout, 3, 1, 1, dims=3, bias=bias, pre_norm=pre_norm,
                    dtype=dtype).cuda()
    conv, bn = unit.Conv_0, unit.BatchNorm_0
    nbn = bn.num_features
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, device="cuda",
                                      generator=gen) * (27 * cin) ** -0.5)
        if bias:
            conv.bias.copy_(torch.randn(cout, device="cuda", generator=gen)
                            * 0.5)
        bn.weight.copy_(torch.rand(nbn, device="cuda", generator=gen) * 0.4
                        + 0.7)
        bn.bias.copy_(torch.randn(nbn, device="cuda", generator=gen) * 0.1)
        bn.running_mean.copy_(torch.randn(nbn, device="cuda",
                                          generator=gen) * 0.1)
        bn.running_var.copy_(torch.rand(nbn, device="cuda", generator=gen)
                             * 0.5 + 0.9)
    return unit


def check_stereonet_kernels(gen):
    """The kernels at StereoNet's shapes. K1 (float32) and K4's bfloat16
    route as the biased 32->32 unit at 24x48x156, batch 1 and 4
    (check_family_units). K4's training route at the 256x512 crop's
    4x24x32x64 in both dtypes, forward and backward (x and the kernel)
    against the plain version's autograd (CONV_GRAD_RTOL; BF16_STEP
    besides). K2 at 24 disparities: forward at the 384x1248 and the
    544x960 batch-4 costs, forward and backward at the training cost.
    Returns {row: extra keys}."""
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    from densematchingbenchmark_tpu_torch.ops.cost_volume import (
        disp_sample_values)
    from densematchingbenchmark_tpu_torch.ops.cuda import (
        conv3d_packed_s1, conv3d_packed_s1_plain, fused_soft_argmin,
        soft_argmin_plain)
    out = check_family_units(
        "stereonet", ((32, 32, STEREO_TRUNK, STEREO_UNITS),), gen,
        batches=(1, EVAL_BATCH), bias=True)
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        # K4's training route, forward and backward
        td, th, tw = STEREO_TRAIN_TRUNK
        x = torch.randn((4, td, th, tw, 32), device="cuda",
                        generator=gen).to(dtype).requires_grad_()
        k = (torch.randn((3, 3, 3, 32, 32), device="cuda", generator=gen)
             * (27 * 32) ** -0.5).to(dtype).requires_grad_()
        g = torch.randn((4, td, th, tw, 32), device="cuda",
                        generator=gen).to(dtype)
        kernels.reset_launch_counts()
        got = conv3d_packed_s1(x, k, pack=1)
        gx, gk = torch.autograd.grad(got, (x, k), g)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["conv3d_packed_s1"] == 1
        want = conv3d_packed_s1_plain(x, k, pack=1)
        wx, wk = torch.autograd.grad(want, (x, k), g)
        errs = []
        for a, b, rtol in ((got, want, CONV_RTOL), (gx, wx, CONV_GRAD_RTOL),
                           (gk, wk, CONV_GRAD_RTOL)):
            tol = (rtol + (0 if f32 else BF16_STEP)) * \
                b.float().abs().max().item()
            e = (a.float() - b.float()).abs().max().item()
            assert e <= tol, (dtype, e, tol)
            errs.append(e)
        print(f"stereonet K4 {'float32' if f32 else 'bf16'} training route "
              f"4x{td}x{th}x{tw} 32->32: forward max_abs_err {errs[0]:.3g}, "
              f"grad x {errs[1]:.3g}, grad kernel {errs[2]:.3g} against the "
              f"plain version's autograd")
        out.setdefault("conv3d_packed_s1" if f32 else
                       "conv3d_packed_s1_bf16_pack1", {})[
            "stereonet_train_max_abs_err"] = max(errs)
        del x, k, g, got, gx, gk, want, wx, wk
    # K2 at 24 disparities
    vals = torch.as_tensor(disp_sample_values(24), device="cuda")
    errs, times = [], {}
    for shape in ((1, 24, 48, 156), (EVAL_BATCH, 24, 68, 120),
                  (4, 24, 32, 64)):
        cost = (torch.randn(shape, device="cuda", generator=gen)
                * 3).requires_grad_()
        kernels.reset_launch_counts()
        got = fused_soft_argmin(cost, 24)
        g = torch.randn_like(got)
        (gc,) = torch.autograd.grad(got, cost, g)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["fused_soft_argmin"] == 1
        assert kernels.launch_counts()["fused_soft_argmin_backward"] == 1
        want = soft_argmin_plain(cost, vals)
        (wc,) = torch.autograd.grad(want, cost, g)
        e = (got - want).abs().max().item()
        eg = (gc - wc).abs().max().item()
        assert e <= ARGMIN_ATOL, (shape, e)
        assert eg <= ARGMIN_GRAD_RTOL * wc.abs().max().item(), (shape, eg)
        errs.append(e)
        c = cost.detach()
        times[shape] = (time_ms(lambda: fused_soft_argmin(c, 24)),
                        bound_ms(6 * c.numel(), 4 * (c.numel() + 24
                                                     + c[:, 0].numel()))[0])
        del cost, got, gc, want, wc, c
    print("stereonet K2 at 24 disparities (not a multiple of its 32-sample "
          "block): " + ", ".join(
              f"{list(s)} {t:.4f} ms, bound {b:.4f}" for s, (t, b)
              in times.items()) + f"; forward max_abs_err {max(errs):.3g} "
          "px, backward within ARGMIN_GRAD_RTOL of the plain autograd")
    out["fused_soft_argmin"] = {"stereonet_max_abs_err": max(errs),
                                "stereonet_ms": times[1, 24, 48, 156][0],
                                "stereonet_bound_ms":
                                    times[1, 24, 48, 156][1]}
    torch.cuda.empty_cache()
    return out


def stereonet_slice_phase(smi):
    """StereoNet inference at full width: the 4-stage config in float32
    and bfloat16 over three random 375x1242 pairs, the 2-stage config over
    one pair in each dtype, with the launches of each run asserted; the
    bfloat16-vs-float32 gap on the same weights; the layers of each
    4-stage forward (the refinement's share); a small 4-stage model on the
    card against the CPU in each dtype. Returns the float32 and bfloat16
    launch counts."""
    from densematchingbenchmark_tpu_torch.apis import (StereoModel,
                                                       inference_stereo,
                                                       init_model)
    rng = np.random.RandomState(5)
    pairs = random_pairs(rng, PAIRS, IMAGE)
    launches = {"_f32": None, "_bf16": None}
    runs = {}
    for config, run_pairs in ((STEREO_CONFIG, pairs),
                              (STEREO_TWO, pairs[:1])):
        for suffix in ("_f32", "_bf16"):
            stages = 4 if config == STEREO_CONFIG else 2
            disps, counts, bf16, ms, parts, peak = family_forward(
                config + suffix, run_pairs, PADDED, STEREO_UNITS,
                STEREO_UNITS, 1, stages)
            # the upsampled soft-argmin: an expectation over 0..23 times 8
            assert max(ds[-1].max() for ds in disps) <= 23 * 8 + 1e-2
            runs[config, suffix] = disps
            launches[suffix] = (counts if launches[suffix] is None else
                                {k: launches[suffix][k] + v
                                 for k, v in counts.items()})
            share = 100 * parts["disp_refinement"] / parts["forward"]
            print(f"stereonet {config + suffix}: inference_stereo over "
                  f"{len(run_pairs)} pairs {IMAGE} padded to {PADDED}, "
                  f"{len(disps[0])} disparities each, finite; launches "
                  f"{counts} (bf16 route {bf16}); forward {ms:.2f} ms "
                  f"(median of {FORWARD_REPS}, CUDA events), by layer "
                  + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
                  + f" ms: the refinement {share:.1f} % of the forward; "
                  f"peak {peak:.2f} GiB at batch 1; {smi}")
    gaps = [[float(np.abs(a - b).mean()) for a, b in zip(da, db)]
            for da, db in zip(runs[STEREO_CONFIG, "_f32"],
                              runs[STEREO_CONFIG, "_bf16"])]
    init = max(g[-1] for g in gaps)
    print(f"stereonet: bf16 vs float32 on the same weights (seed 0), mean "
          f"|gap| by disparity (best first) over the pairs: "
          + "; ".join(", ".join(f"{x:.4f}" for x in g) for g in gaps)
          + f" px (the initial disparity's within BF16_GAP_ATOL "
          f"{BF16_GAP_ATOL})")
    assert np.isfinite(gaps).all() and init <= BF16_GAP_ATOL, gaps

    # a small model on the card against the same weights on the CPU
    small = random_pairs(rng, 1, SMALL_IMAGE)
    pad = tuple(-(-s // 32) * 32 for s in SMALL_IMAGE)
    cpu_disps, card_disps, report = {}, {}, []
    for suffix in ("_f32", "_bf16"):
        cpu = init_model(STEREO_CONFIG + suffix, device="cpu", seed=4,
                         **STEREO_SMALL)
        damp_bn(cpu.module, 4)
        card = StereoModel(cpu.cfg, copy.deepcopy(cpu.module).cuda(),
                           torch.device("cuda"))
        want = inference_stereo(cpu, small, pad_to_shape=pad)[0]["disps"]
        got = inference_stereo(card, small, pad_to_shape=pad)[0]["disps"]
        cpu_disps[suffix], card_disps[suffix] = want, got
        if suffix == "_f32":
            err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
            assert err <= CPU_ATOL, (suffix, err)
            report.append(f"float32 {err:.4g} px (max, tolerance "
                          f"{CPU_ATOL})")
            continue
        gaps = [float(np.abs(g - w).mean()) for g, w in zip(got, want)]
        own = [float(np.abs(a - b).mean()) for a, b in zip(
            want, cpu_disps["_f32"])]
        card_own = [float(np.abs(a - b).mean()) for a, b in zip(
            got, card_disps["_f32"])]
        assert gaps[-1] <= BF16_CPU_ATOL, (gaps, own)
        assert all(g <= STEREO_BF16_NOISE * o + 0.01
                   for g, o in zip(gaps, own)), (gaps, own)
        assert all(STEREO_OWN_RANGE[0] * o <= c
                   <= STEREO_OWN_RANGE[1] * o + 1e-3
                   for c, o in zip(card_own[:-1], own)), (card_own, own)
        report.append("bf16 mean " + ", ".join(f"{g:.4f}" for g in gaps)
                      + " px by disparity (best first), where the CPU's own "
                      "bf16 and float32 lie " + ", ".join(
                          f"{o:.4f}" for o in own) + " px apart (tolerance "
                      f"{STEREO_BF16_NOISE}x that + 0.01; the initial "
                      f"disparity {BF16_CPU_ATOL}) and the card's own "
                      + ", ".join(f"{c:.4f}" for c in card_own)
                      + f" (refined within {STEREO_OWN_RANGE}x the CPU's)")
    print(f"stereonet small model ({STEREO_SMALL['model.max_disp']} disps, "
          f"{SMALL_IMAGE}), card vs CPU plain versions: " + "; ".join(report))
    return launches["_f32"], launches["_bf16"]


def write_sceneflow_dataset(root):
    """SceneFlow-layout files from SyntheticStereoDataset (seeded,
    disparities 1-191, 540x960): RGB PNGs (pair i with row filter i % 5),
    PFM disparities of both views and an annotation JSON, as
    data/datasets.SceneFlowDataset reads them. Returns (its path, the
    items)."""
    from densematchingbenchmark_tpu_torch.data import SyntheticStereoDataset
    from densematchingbenchmark_tpu_torch.data import io as dio
    items = []
    for i in range(STEREO_EVAL_N):
        s = SyntheticStereoDataset(length=1, height=STEREO_EVAL_IMAGE[0],
                                   width=STEREO_EVAL_IMAGE[1], max_disp=192,
                                   seed=10 + i, with_right_disp=True).load(0)
        item = {"height": STEREO_EVAL_IMAGE[0],
                "width": STEREO_EVAL_IMAGE[1]}
        for key, kind, rel in (
                ("leftImage", "left_image_path", f"frames/left/{i:04d}.png"),
                ("rightImage", "right_image_path",
                 f"frames/right/{i:04d}.png"),
                ("leftDisp", "left_disp_map_path",
                 f"disparity/left/{i:04d}.pfm"),
                ("rightDisp", "right_disp_map_path",
                 f"disparity/right/{i:04d}.pfm")):
            path = os.path.join(root, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            if key.endswith("Disp"):
                dio.save_pfm(path, s[key][..., 0])
            else:
                dio.save_png(path, np.clip(np.round(s[key]), 0, 255).astype(
                    np.uint8), i % 5)
            item[kind] = rel
        items.append(item)
    ann = os.path.join(root, "sceneflow_test.json")
    with open(ann, "w") as fp:
        json.dump(items, fp)
    return ann, items


def family_eval_phase(smi, root, ann, items, config, units, argmins,
                      n_disps, bf16_units=None, overrides=None,
                      bf16_atol=(EVAL_EPE_ATOL, EVAL_PX_ATOL), prepare=None):
    """tools/test.main on ``config`` (with ``prepare``, the weights it
    draws on the seeded module, from a checkpoint in the work directory)
    in float32 and bfloat16 over the SceneFlow-layout set at ``root``,
    padded to the config's test shape
    (after ``overrides``, a dict of dotted keys), at eval batch 4 (two
    batches), every disparity of eval_disparity_id that the model's
    ``n_disps`` hold scored (as JAX's loop, the tool skips the others):
    launches
    asserted (a batch K1 ``units`` or K4's bf16 route ``bf16_units``, K2
    ``argmins``); each run's metrics against batch-1 inference_stereo on
    the same files with per-sample metrics in float64 (EVAL_EPE_ATOL,
    EVAL_PX_ATOL; ``bf16_atol`` in bfloat16); the bfloat16 EPEs beside
    float32's; the eval step's ms
    a sample and peak at batch 4 and 1. Returns the float32 and bfloat16
    launch counts."""
    from densematchingbenchmark_tpu_torch.apis import (inference_stereo,
                                                       init_model)
    from densematchingbenchmark_tpu_torch.configs import get_config
    from densematchingbenchmark_tpu_torch.data import (build_dataset,
                                                       collate, transforms)
    from densematchingbenchmark_tpu_torch.data import io as dio
    from densematchingbenchmark_tpu_torch.evaluation import eval_loop
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    from densematchingbenchmark_tpu_torch.tools import test as test_tool
    from densematchingbenchmark_tpu_torch.utils.checkpoint import \
        CheckpointManager
    overrides = dict(overrides or {})
    work = os.path.join(root, "work")
    if prepare is not None:
        module = prepare(init_model(config + "_f32", device="cpu", seed=0,
                                    **overrides).module)
        CheckpointManager(work).save(0, {"module": module.state_dict()})
        del module
    bf16_units = units if bf16_units is None else bf16_units
    launches, by_dtype = {}, {}
    batches = -(-STEREO_EVAL_N // EVAL_BATCH)
    for suffix in ("_f32", "_bf16"):
        name = config + suffix
        f32 = suffix == "_f32"
        cfg = get_config(name, **overrides)
        ids = tuple(i for i in cfg["eval_disparity_id"] if i < n_disps)
        pad = tuple(cfg["data"]["test"]["input_shape"])
        assert cfg["model"]["eval"]["batch_size"] == EVAL_BATCH
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        results, n = test_tool.main([
            "--config", name, "--work-dir", work,
            "--data-root", root, "--annfile", ann, "--override",
            "data.test.use_right_disp=True",
            *(f"{k}={v!r}" for k, v in overrides.items())])
        torch.cuda.synchronize()
        counts, bf16 = kernels.launch_counts(), kernels.bf16_launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        k1, k4 = (units * batches, 0) if f32 else (0, bf16_units * batches)
        assert n == STEREO_EVAL_N and counts == {
            "fused_conv3d": k1,
            "fused_soft_argmin": argmins * batches,
            "fused_soft_argmin_backward": 0,
            "fused_upsample_soft_argmin": 0,
            "conv3d_packed_s1": k4,
            "conv3d_packed_s1_v2": 0}, (n, counts)
        assert bf16["conv3d_packed_s1"] == k4, bf16
        assert {k.split("/")[0] for k in results} == {
            f"disp_{i}" for i in ids}, sorted(results)
        launches[suffix] = counts
        by_dtype[suffix] = results

        # the reference: batch-1 inference_stereo on the same files,
        # metrics per sample in float64
        model = init_model(cfg, seed=0, checkpoint_dir=work)
        sums = {}
        for item in items:
            path = lambda k: os.path.join(root, item[k])
            out = inference_stereo(model, [{
                "leftImage": dio.load_image(path("left_image_path")),
                "rightImage": dio.load_image(path("right_image_path"))}],
                pad_to_shape=pad)[0]["disps"]
            gt = dio.load_pfm(path("left_disp_map_path"))[0]
            rgt = dio.load_pfm(path("right_disp_map_path"))[0]
            for did in ids:
                for k, v in metrics_f64(out[did][0, ..., 0], gt,
                                        rgt).items():
                    key = f"disp_{did}/{k}"
                    sums[key] = sums.get(key, 0.0) + v
        ref = {k: v / len(items) for k, v in sums.items()}
        epe, px = compare_metrics(results, ref, f"{name} eval",
                                  *(() if f32 else (bf16_atol,)))

        # the eval step (forward + metrics) a sample at batch 4 and 1
        test_cfg = dict(cfg["data"], data_root=root, test=dict(
            cfg["data"]["test"], annfile=ann, use_right_disp=True))
        ds = build_dataset(test_cfg, "test", transforms.make_eval_transform(
            pad, cfg["data"]["mean"], cfg["data"]["std"]))
        ecfg = cfg["model"]["eval"]
        step = eval_loop.make_eval_metrics_step(
            model.module, ecfg["lower_bound"], ecfg["upper_bound"], ids,
            ecfg["eval_occlusion"])
        b4 = eval_loop.to_device(collate([ds[i] for i in range(
            EVAL_BATCH)]), model.device)
        b1 = {k: v[:1] for k, v in b4.items()}
        peaks = {}
        for b, bt in ((EVAL_BATCH, b4), (1, b1)):
            step(bt)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step(bt)
            torch.cuda.synchronize()
            peaks[b] = torch.cuda.max_memory_allocated() / 2 ** 30
        ms4 = time_ms(lambda: step(b4), 3) / EVAL_BATCH
        ms1 = time_ms(lambda: step(b1), 3)
        print(f"eval {name}: {n} SceneFlow-layout samples "
              f"{STEREO_EVAL_IMAGE} padded to {pad}, {batches} batches of "
              f"{EVAL_BATCH}; launches {counts}; EPE "
              + ", ".join(f"disp_{i} {results[f'disp_{i}/epe']:.4f}"
                          for i in ids)
              + f" px; vs the batch-1 reference: EPE {epe:.3g} px, n-px "
              f"{px:.3g} points; eval step {ms4:.2f} ms a sample at batch "
              f"{EVAL_BATCH}, {ms1:.2f} at batch 1 (device, CUDA events); "
              f"peak {peaks[EVAL_BATCH]:.2f} GiB at batch {EVAL_BATCH}, "
              f"{peaks[1]:.2f} at batch 1 ({peak:.2f} the tool's run); {smi}")
        if "--profile" in sys.argv[1:]:
            device_profile(f"{name} eval step batch {EVAL_BATCH}",
                           lambda: step(b4), convs=8)
        del model, step, b4, b1
        torch.cuda.empty_cache()
    gap = max(abs(by_dtype["_bf16"][k] - by_dtype["_f32"][k])
              for k in by_dtype["_f32"] if k.endswith("epe"))
    print(f"eval {config}: bf16 EPEs within {gap:.4f} px of float32's "
          f"(random weights, the same seed)")
    assert np.isfinite(gap)
    return launches["_f32"], launches["_bf16"]


def stereonet_eval_phase(smi, root, ann, items):
    """``family_eval_phase`` on StereoNet/scene_flow_8x_4stage (its
    544x960 test shape; a batch K1 4 or K4's bf16 route 4, K2 1; all four
    disparities scored)."""
    from densematchingbenchmark_tpu_torch.configs import get_config
    cfg = get_config(STEREO_CONFIG + "_f32")
    assert tuple(cfg["eval_disparity_id"]) == (0, 1, 2, 3)
    assert tuple(cfg["data"]["test"]["input_shape"]) == STEREO_EVAL_PAD
    return family_eval_phase(smi, root, ann, items, STEREO_CONFIG,
                             STEREO_UNITS, 1, 4)


def fault8_phase(smi):
    """ROADMAP §3 fault 8 on the card: fusable units at any width run on
    their kernels, in eval and in training, never the library's conv: one
    launch a slice of Ci (``route_widths``: zero channels up to the
    block's multiples, 128 -> 128 in bfloat16 as two slices of 64), against
    the same unit on the CPU (float32 within CONV_RTOL, bfloat16 within
    2 BF16_STEP, of the largest output); StereoNet's 32 -> 32 one launch.
    In eval, the unit's call is timed beside the library's conv + BN +
    ReLU on the same input (median of 10, CUDA events)."""
    from densematchingbenchmark_tpu_torch.models import layers
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    report = []

    def refuse(*args):
        raise AssertionError("a fusable unit ran the library's conv")
    library_conv, layers.library_conv = layers.library_conv, refuse
    try:
        for ci, co in FAULT8_WIDTHS:
            for dtype in (torch.float32, torch.bfloat16):
                for train in (False, True):
                    cpu = damp_bn(layers.ConvUnit(
                        ci, co, 3, 1, 1, dims=3, bias=True, dtype=dtype),
                        ci).train(train)
                    with torch.no_grad():
                        cpu.Conv_0.bias.normal_(0, 0.3, generator=torch
                                                .Generator().manual_seed(co))
                    card = copy.deepcopy(cpu).cuda()
                    x = torch.randn((2, 12, 24, 78, ci), generator=torch
                                    .Generator().manual_seed(1)).to(dtype)
                    kernels.reset_launch_counts()
                    with torch.no_grad():
                        got = card(x.cuda())
                    torch.cuda.synchronize()
                    counts = kernels.launch_counts()
                    slices = len(card.widths.slices)
                    assert slices == (2 if (ci, dtype) == (
                        128, torch.bfloat16) else 1), card.widths
                    want = dict.fromkeys(counts, 0)
                    want["conv3d_packed_s1" if train or dtype ==
                         torch.bfloat16 else "fused_conv3d"] = slices
                    assert counts == want, (ci, co, dtype, train, counts)
                    with torch.no_grad():
                        ref = cpu(x)
                    top = ref.float().abs().max().item()
                    tol = (CONV_RTOL if dtype == torch.float32
                           else CONV_RTOL + 2 * BF16_STEP) * top
                    err = (got.float().cpu() - ref.float()).abs().max() \
                        .item()
                    assert got.dtype == dtype and err <= tol, (
                        ci, co, dtype, train, err, tol)
                    times = ""
                    if not train:
                        xc = x.cuda()
                        with torch.no_grad():
                            ms = time_ms(lambda: card(xc), 10)
                            lib_ms = time_ms(lambda: card._norm_act(
                                library_conv(card.Conv_0, xc, dtype)), 10)
                        times = (f" {ms:.3f} ms (cuDNN conv + BN + ReLU "
                                 f"{lib_ms:.3f})")
                    report.append(f"{ci}->{co} {str(dtype)[6:]} "
                                  f"{'train' if train else 'eval'} "
                                  f"{card.widths.ci}->{card.widths.co} "
                                  f"x{slices} {err:.3g}{times}")
    finally:
        layers.library_conv = library_conv
    print("fault 8 (width dispatch): units against the CPU, max_abs_err; "
          "every unit on its kernels at the padded widths, one launch a "
          "slice of Ci, no library conv: " + "; ".join(report) + f"; {smi}")


def stereonet_profile_phase():
    """The StereoNet 4-stage forward at 384x1248 batch 1 and a train step
    at its 4x256x512, in float32 and bfloat16, by kernel."""
    from densematchingbenchmark_tpu_torch.apis import init_model
    from densematchingbenchmark_tpu_torch.configs import get_config
    from densematchingbenchmark_tpu_torch.losses import make_loss_evaluator
    from densematchingbenchmark_tpu_torch.models import build_model
    from densematchingbenchmark_tpu_torch.trainer import (TrainState,
                                                          build_optimizer,
                                                          make_train_step)
    x = torch.randn((1, *PADDED, 3), device="cuda")
    for suffix in ("_f32", "_bf16"):
        name = STEREO_CONFIG + suffix
        model = init_model(name, seed=0)
        with torch.inference_mode():
            device_profile(f"{name} forward 1x{PADDED[0]}x{PADDED[1]}",
                           lambda: model.forward(x, x), top=16, convs=6)
        del model
        cfg = get_config(name)
        crop = cfg["data"]["train"]["input_shape"]
        batch = small_batch(cfg, crop, (crop[0] + 32, crop[1] + 64), 192,
                            "cuda")
        module = build_model(cfg, torch.Generator().manual_seed(0)).cuda()
        state = TrainState.create(module, build_optimizer(cfg, module,
                                                          10)[0], 1)
        step = make_train_step(make_loss_evaluator(cfg["model"]["losses"]))
        device_profile(f"{name} train step "
                       f"{cfg['data']['batch_size_per_device']}x{crop[0]}x"
                       f"{crop[1]}", lambda: step(state, batch), top=20,
                       convs=8)
        del module, state, batch
        torch.cuda.empty_cache()


# GCNet at full width: max_disp 192, the concatenation volume at half
# resolution (96 disparities, 64 channels), 10 stride-1 units on K1 / K4
# (c31 and c32, 128->128, in two Ci slices on the bf16 block), the strided
# and transposed units and the 32->1 head on cuDNN, K2 on the
# full-resolution cost of 192 disparities (PSMNet's K2 shape at 384x1248).
GC_CONFIG = "GCNet/scene_flow"
GC_UNITS, GC_BF16_UNITS = 10, 12
GC_SMALL = {"model.max_disp": 32,
            "model.cost_processor.cost_computation.max_disp": 16,
            "model.cost_processor.cost_aggregator.max_disp": 32,
            "model.disp_predictor.max_disp": 32,
            "model.losses.l1_loss.max_disp": 32}
# fault 9: c19 (64->32) on the raw volume of the 544x960 batch-4 eval,
# [4, 96, 272, 480, 64]: 3,208,642,560 elements, past 2^31
FAULT9_C19 = (4, 96, 272, 480, 64)
# DeepPruner (Best 4x, Fast 8x) at full width: max_disp 192, PatchMatch's
# 14 samples and the 9 uniform ones at 1/4 (or 1/8), 20 stride-1 units a
# forward (23 launches in bf16: the three hourglasses' 128->128 units in
# two Ci slices), no K2 (its expectations are plain PyTorch, as JAX's are
# XLA). Its hourglasses halve H and W three times at the feature scale, so
# a frame must be a multiple of 32 (4x) or 64 (8x) each way: JAX's 8x
# model refuses 384x1248 and the configs' 544x960 as the port does, so
# inference runs at 384x1280 (JAX's own measured size) and the 8x eval at
# 576x960.
DP_CONFIGS = ("DeepPruner/scene_flow_4x", "DeepPruner/scene_flow_8x")
DP_PADDED = (384, 1280)
DP_UNITS, DP_BF16_UNITS = 20, 23
DP_EVAL_OVERRIDES = {"DeepPruner/scene_flow_8x":
                     {"data.test.input_shape": (576, 960)}}
# DeepPruner's bfloat16 eval at batch 4 against batch 1: (EPE px, n-px
# points). cuDNN picks its algorithms by batch size, so its bfloat16 convs
# round at other points in the two runs, and PatchMatch's soft selection
# (scores times temperature 7) carries that into the samples: measured
# 0.0034 px and 0.0058 points on the 4x model (float32: 1.5e-5 px)
DP_BF16_EVAL_ATOL = (0.01, 0.05)
DP_SMALL = {"model.max_disp": 64, "model.losses.l1_loss.max_disp": 64,
            "model.losses.quantile_loss.max_disp": 64}


def gc_unit_shapes(h, w):
    """(Cin, Cout, (D, H, W), units) of GCNet's 10 stride-1 units on a
    half-resolution volume of h x w (96 disparities)."""
    return ((64, 32, (96, h, w), 1), (32, 32, (96, h, w), 1),
            *((64, 64, (96 >> k, h >> k, w >> k), 2) for k in (1, 2, 3)),
            (128, 128, (6, h >> 4, w >> 4), 2))


def dp_unit_shapes(h, w):
    """(Cin, Cout, (D, H, W), units) of DeepPruner's 20 stride-1 units on
    features of h x w: the predictor's (14 samples, two hourglasses and
    heads) and the aggregator's (9 samples)."""
    out = []
    for d, first, heads in ((14, 65, 2), (9, 93, 1)):
        out += [(first, 64, (d, h, w), 1), (64, 32, (d, h, w), 1),
                (32, 32, (d, h, w), 1), (32, 16, (d, h, w), 1),
                (32, 32, (d, h // 2, w // 2), heads),
                (64, 64, (d, h // 4, w // 4), heads),
                (128, 128, (d, h // 8, w // 8), heads),
                (16, 32, (d, h, w), heads)]
    return tuple(out)


def check_family_units(label, shapes, gen, batches=(1,), bias=False,
                       train=None, pre_norm=False):
    """K1 (float32) and K4's bfloat16 route (the eval unit on its kept
    operands) as ``label``'s stride-1 units at ``shapes`` ((Cin, Cout,
    (D, H, W), units a forward) of a 384-row frame; with ``bias`` a conv
    bias), at each of ``batches``: one launch a slice of Ci and nothing
    else, against the plain version on the folded operands and the
    unfused conv (+ bias), BN and ReLU in float32 (CONV_RTOL of the
    largest output; BF16_STEP besides, against the unfused conv one a
    slice of Ci). With ``pre_norm`` the units are AnyNet's BN -> ReLU ->
    conv: the plain version and the unfused conv (+ bias) read the unit's
    own BN -> ReLU of the input, the epilogue is unit scale and the bias
    without ReLU, and the unit is timed on that input as the kernel
    reads it (padded), beside cuDNN's conv with its bias in one call.
    Then, with ``train`` ((shapes, batch)), K4's float32 training route
    (unit scale) against its plain version. Each unit timed at its row's
    first batch: one call, chained, the plain version, cuDNN's conv (+ the
    affine and ReLU in eval, but for a pre-norm unit) in the unit's dtype
    and the bound; summed over a forward. Returns {row: extra keys}."""
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    from densematchingbenchmark_tpu_torch.ops.cuda import (
        conv3d_packed_s1, conv3d_packed_s1_plain, conv3d_plain)
    rows = [("fused_conv3d", torch.float32, batches, shapes),
            ("conv3d_packed_s1_bf16_pack1", torch.bfloat16, batches, shapes)]
    if train is not None:
        rows.append(("conv3d_packed_s1", torch.float32, (train[1],),
                     train[0]))
    out = {}
    for row, dtype, row_batches, units in rows:
        f32, is_train = dtype == torch.float32, row == "conv3d_packed_s1"
        size = 4 if f32 else 2
        tot = dict.fromkeys(("ms", "chained_ms", "plain_ms", "library_ms",
                             "bound_ms", "max_abs_err"), 0.0)
        launches = 0
        for ci, co, (d, h, w), n in units:
            for batch in row_batches:
                unit = biased_unit(ci, co, dtype, gen, bias=bias,
                                   pre_norm=pre_norm).eval()
                x = torch.randn((batch, d, h, w, ci), device="cuda",
                                generator=gen).to(dtype)
                kernel = unit.Conv_0.weight.detach().permute(
                    2, 3, 4, 1, 0).to(dtype).contiguous()
                with torch.no_grad():
                    inv, shift = unit.folded_bn()
                if is_train:
                    # the unit's training call: its input and kernel padded
                    # with zero channels to ``widths``, K4 at unit scale
                    xp = F.pad(x, (0, unit.widths.ci - ci))
                    kp = unit._kernel().detach()
                    call = lambda: conv3d_packed_s1(xp, kp, pack=1)
                    plain = lambda: conv3d_packed_s1_plain(xp, kp, pack=1)
                    lib_call = lambda: F.conv3d(x.movedim(-1, 1),
                                                unit.Conv_0.weight, padding=1)
                    slices = 1
                else:
                    call = timed = lambda: unit(x)
                    xn, relu = x, True
                    if pre_norm:
                        with torch.no_grad():
                            xn = unit._norm_act(x)
                        xk = F.pad(xn, (0, unit.widths.ci - ci))
                        timed = lambda: unit._fused_eval(xk)
                        relu = False
                    plain = lambda: (
                        conv3d_plain(xn, kernel, inv, shift, relu) if f32
                        else conv3d_packed_s1_plain(xn, kernel, inv, shift,
                                                    1, relu))
                    w_oi = unit.Conv_0.weight.to(dtype)
                    s5, b5 = (t.view(1, -1, 1, 1, 1).to(dtype)
                              for t in (inv, shift))
                    # pre-norm: the unit's function on its normed input is
                    # one library call, the conv with its bias
                    b_conv = None if unit.Conv_0.bias is None else \
                        unit.Conv_0.bias.to(dtype)
                    lib_call = lambda: F.conv3d(
                        xn.movedim(-1, 1), w_oi, b_conv, padding=1)
                    if relu:
                        lib_call = lambda: torch.relu(F.conv3d(
                            x.movedim(-1, 1), w_oi, padding=1) * s5 + b5)
                    slices = len(unit.widths.slices)
                name = "fused_conv3d" if f32 and not is_train else \
                    "conv3d_packed_s1"
                kernels.reset_launch_counts()
                with torch.inference_mode():
                    got = call()
                    torch.cuda.synchronize()
                    counts = kernels.launch_counts()
                    assert counts[name] == slices and \
                        sum(counts.values()) == slices, (ci, co, counts)
                    want = plain()
                    if is_train:
                        got, want = got[..., :co], want[..., :co]
                    top = want.float().abs().max().item()
                    tol = (CONV_RTOL + (0 if f32 else BF16_STEP)) * top
                    err = (got.float() - want.float()).abs().max().item()
                    assert err <= tol, (label, row, ci, co, batch, err, tol)
                    del want
                    if not is_train:
                        conv, bn = unit.Conv_0, unit.BatchNorm_0
                        if pre_norm:
                            unfused = F.conv3d(
                                xn.movedim(-1, 1).float(),
                                conv.weight.to(dtype).float(), conv.bias,
                                padding=1).movedim(1, -1)
                        else:
                            unfused = torch.relu_(F.batch_norm(
                                F.conv3d(x.movedim(-1, 1).float(),
                                         conv.weight.to(dtype).float(),
                                         conv.bias, padding=1),
                                bn.running_mean, bn.running_var, bn.weight,
                                bn.bias, False, 0.0, bn.eps)).movedim(1, -1)
                        err_unfused = (got.float() - unfused).abs().max() \
                            .item()
                        # each slice of Ci rounds its sum to bfloat16 first
                        tol_unfused = (CONV_RTOL + (0 if f32 else BF16_STEP
                                                    * slices)) * top
                        assert err_unfused <= tol_unfused, (
                            label, row, ci, co, batch, err_unfused,
                            tol_unfused)
                        del unfused
                    del got
                    tot["max_abs_err"] = max(tot["max_abs_err"], err)
                    if batch != row_batches[0]:
                        del unit, x
                        continue
                    if not is_train:
                        call = timed
                    ms, chain = time_ms(call), chained_ms(call)
                    lib, plain_ms = time_ms(lib_call), time_ms(plain, 1, 0)
                vox = batch * d * h * w
                b_ms, b_by = bound_ms(
                    2 * 27 * ci * co * vox,
                    size * (vox * (ci + co) + 27 * ci * co) + 8 * co,
                    PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS)
                for k, v in (("ms", ms), ("chained_ms", chain),
                             ("plain_ms", plain_ms), ("library_ms", lib),
                             ("bound_ms", b_ms)):
                    tot[k] += n * v
                launches += n * slices
                print(f"{label} {row} {ci}->{co} {batch}x{d}x{h}x{w} (x{n}/"
                      f"{'step' if is_train else 'fwd'}, {slices} launch"
                      f"{'es' if slices > 1 else ''}): {ms:.3f} ms, chained "
                      f"{chain:.3f}; cuDNN {lib:.3f}; plain {plain_ms:.3f}; "
                      f"bound {b_ms:.4f} ({b_by}); max_abs_err {err:.3g} "
                      f"(tolerance {tol:.3g}"
                      + ("" if is_train else
                         f"; {err_unfused:.3g} against the unfused conv, "
                         f"tolerance {tol_unfused:.3g}")
                      + ")")
                del unit, x
        torch.cuda.empty_cache()
        what = (f"per step's forward ({launches} launches, batch "
                f"{row_batches[0]} at the train crop)" if is_train else
                f"per forward ({launches} launches, batch "
                f"{row_batches[0]}; max_abs_err over batches "
                f"{list(row_batches)})")
        out[row] = {f"{label}_unit": what,
                    **{f"{label}_{k}": v for k, v in tot.items()}}
        print(f"{label} {row} {what}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in tot.items()))
    return out


def fault9_phase(smi, gen):
    """ROADMAP section 3 fault 9: GCNet's c19 (64->32, BN, ReLU) on the
    raw volume of the 544x960 batch-4 eval, FAULT9_C19 (past 2^31
    elements), as the eval unit runs it: K1 in float32 and K4's bfloat16
    route, one launch and no library conv, against cuDNN's conv + BN +
    ReLU in float32 on the same (rounded) operands (CONV_RTOL of the
    largest output; BF16_STEP besides); one call each and the bound.
    Returns {row: extra keys}."""
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    out = {}
    b, d, h, w, ci = FAULT9_C19
    vox = b * d * h * w
    assert vox * ci >= 2 ** 31
    for row, dtype in (("fused_conv3d", torch.float32),
                       ("conv3d_packed_s1_bf16_pack1", torch.bfloat16)):
        f32 = dtype == torch.float32
        unit = biased_unit(ci, 32, dtype, gen, bias=False).eval()
        x = torch.randn(FAULT9_C19, device="cuda", generator=gen).to(dtype)
        kernels.reset_launch_counts()
        with torch.inference_mode():
            got = unit(x)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            assert counts["fused_conv3d" if f32 else "conv3d_packed_s1"] \
                == 1 and sum(counts.values()) == 1, counts
            conv, bn = unit.Conv_0, unit.BatchNorm_0
            want = F.conv3d(x.movedim(-1, 1).float(),
                            conv.weight.to(dtype).float(), padding=1)
            want = torch.relu_(F.batch_norm(
                want, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                False, 0.0, bn.eps)).movedim(1, -1)
            top = want.abs().max().item()
            err = max((got[i].float() - want[i]).abs().max().item()
                      for i in range(b))
            del want
            tol = (CONV_RTOL + (0 if f32 else BF16_STEP)) * top
            assert err <= tol, (row, err, tol)
            ms = time_ms(lambda: unit(x), 3)
            inv, shift = unit.folded_bn()
            s5, b5 = (t.view(1, -1, 1, 1, 1).to(dtype) for t in (inv, shift))
            w_oi = conv.weight.to(dtype)
            lib = time_ms(lambda: torch.relu(F.conv3d(
                x.movedim(-1, 1), w_oi, padding=1) * s5 + b5), 3)
        b_ms, b_by = bound_ms(2 * 27 * ci * 32 * vox,
                              (4 if f32 else 2) * vox * (ci + 32),
                              PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS)
        print(f"fault 9: c19 64->32 at {list(FAULT9_C19)} ({vox * ci:,} "
              f"elements in, {vox * 32:,} out) on "
              f"{'K1' if f32 else 'K4 bf16'}: {ms:.2f} ms (one launch), "
              f"cuDNN conv+affine+ReLU {lib:.2f} ms, bound {b_ms:.2f} "
              f"({b_by}); max_abs_err {err:.3g} against cuDNN's conv + BN "
              f"+ ReLU in float32 (tolerance {tol:.3g}); {smi}")
        out[row] = {"fault9_unit": f"c19 64->32 at {list(FAULT9_C19)}",
                    "fault9_ms": ms, "fault9_library_ms": lib,
                    "fault9_bound_ms": b_ms, "fault9_max_abs_err": err}
        del unit, x, got
        torch.cuda.empty_cache()
    return out


def layer_breakdown(model, left, right, reps=3):
    """Device ms (CUDA events, median of ``reps`` after one warm-up) of
    each top-level submodule of the model over one eval forward (summed
    over its calls), of the forward, and of what runs between them
    ('between': volumes, PatchMatch, expectations, resizes)."""
    marks, hooks = [], []

    def record(name, kind):
        def hook(*_):
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            marks.append((name, kind, event))
        return hook

    for name, child in model.module.named_children():
        hooks.append(child.register_forward_pre_hook(record(name, 0)))
        hooks.append(child.register_forward_hook(record(name, 1)))
    runs = []
    try:
        for _ in range(reps + 1):
            marks.clear()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model.forward(left, right)
            end.record()
            end.synchronize()
            parts, opened = {}, {}
            for name, kind, event in marks:
                if kind == 0:
                    opened[name] = event
                else:
                    parts[name] = parts.get(name, 0.0) + \
                        opened.pop(name).elapsed_time(event)
            parts["forward"] = start.elapsed_time(end)
            parts["between"] = 2 * parts["forward"] - sum(parts.values())
            runs.append(parts)
    finally:
        for h in hooks:
            h.remove()
    return {k: float(np.median([r[k] for r in runs[1:]])) for k in runs[1]}


def family_forward(name, pairs, pad, units, bf16_units, argmins, n_disps,
                   prepare=None):
    """init_model(name, seed 0; then ``prepare`` on its module) +
    inference_stereo over ``pairs`` padded to ``pad``: launches asserted
    (a forward K1 ``units`` in float32 or K4's bf16 route ``bf16_units``,
    K2 ``argmins``, K3 none), ``n_disps`` disparities each, finite and >=
    0; the forward's ms, its layers' and the peak. Returns (disparities, counts, bf16 counts, ms, layers, peak
    GiB)."""
    from densematchingbenchmark_tpu_torch.apis import (inference_stereo,
                                                       init_model)
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    model = init_model(name, seed=0)
    if prepare is not None:
        prepare(model.module)
    f32 = model.cfg["model"]["dtype"] == "float32"
    n = len(pairs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    results = inference_stereo(model, pairs, pad_to_shape=pad)
    torch.cuda.synchronize()
    counts, bf16 = kernels.launch_counts(), kernels.bf16_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    k1, k4 = (units * n, 0) if f32 else (0, bf16_units * n)
    assert counts == {"fused_conv3d": k1, "fused_soft_argmin": argmins * n,
                      "fused_soft_argmin_backward": 0,
                      "fused_upsample_soft_argmin": 0,
                      "conv3d_packed_s1": k4,
                      "conv3d_packed_s1_v2": 0}, (name, counts)
    assert bf16["conv3d_packed_s1"] == k4, bf16
    disps = [r["disps"] for r in results]
    for ds in disps:
        assert len(ds) == n_disps, len(ds)
        for d in ds:
            assert d.shape == (1, *IMAGE, 1) and np.isfinite(d).all()
            assert d.min() >= -1e-3, d.min()
    left, right = padded_input(model, pairs[0], pad)
    with torch.inference_mode():
        ms = time_ms(lambda: model.forward(left, right), FORWARD_REPS)
    parts = layer_breakdown(model, left, right)
    if "--profile" in sys.argv[1:]:
        device_profile(f"{name} forward {pad}",
                       lambda: model.forward(left, right), convs=8)
    del model
    torch.cuda.empty_cache()
    return disps, counts, bf16, ms, parts, peak


def small_card_vs_cpu(label, config, small, shape, n_disps, prepare=None,
                      refined=()):
    """A small model of ``config`` (``small`` overrides, BN drawn with
    damp_bn, or the weights ``prepare`` draws on its module) on the card
    against the same weights through the plain versions on the CPU, one
    random pair of ``shape``: float32 within CPU_ATOL max, bfloat16 within
    BF16_CPU_ATOL mean, every disparity but those of ``refined``, the CPU's
    own bfloat16-vs-float32 gap beside it. A disparity of ``refined``
    carries a refinement's bfloat16 rounding on each side at the scale of
    its residual: it is held as test_tiny_anynet_on_card_matches_cpu and
    the StereoNet test hold it, within twice the CPU's own gap plus 0.01
    px, and the card's own gap within 0.8-1.25 times the CPU's."""
    from densematchingbenchmark_tpu_torch.apis import (StereoModel,
                                                       inference_stereo,
                                                       init_model)
    rng = np.random.RandomState(6)
    pair = random_pairs(rng, 1, shape)
    report = []
    for suffix in ("_f32", "_bf16"):
        cpu = init_model(config + suffix, device="cpu", seed=4, **small)
        (prepare or (lambda m: damp_bn(m, 4)))(cpu.module)
        card = StereoModel(cpu.cfg, copy.deepcopy(cpu.module).cuda(),
                           torch.device("cuda"))
        want = inference_stereo(cpu, pair)[0]["disps"]
        got = inference_stereo(card, pair)[0]["disps"]
        assert len(got) == len(want) == n_disps
        if suffix == "_f32":
            err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
            assert err <= CPU_ATOL, (label, err)
            report.append(f"float32 {err:.4g} px max (tolerance "
                          f"{CPU_ATOL})")
            cpu_f32, card_f32 = want, got
        else:
            gaps = [float(np.abs(g - w).mean()) for g, w in zip(got, want)]
            own = [float(np.abs(w - f).mean()) for w, f in zip(want,
                                                               cpu_f32)]
            card_own = [float(np.abs(g - f).mean()) for g, f in zip(
                got, card_f32)]
            for i, (g, o, c) in enumerate(zip(gaps, own, card_own)):
                if i in refined:
                    assert g <= 2 * o + 0.01 and \
                        0.8 * o <= c <= 1.25 * o + 1e-3, (label, i, g, o, c)
                else:
                    assert g <= BF16_CPU_ATOL, (label, i, gaps, own)
            report.append("bf16 mean " + ", ".join(f"{g:.4f}" for g in gaps)
                          + f" px (tolerance {BF16_CPU_ATOL}"
                          + (f", {list(refined)} by the CPU's own gap"
                             if refined else "")
                          + "; the CPU's own bf16 - float32 gap " + ", ".join(
                              f"{g:.4f}" for g in own) + ", the card's "
                          + ", ".join(f"{g:.4f}" for g in card_own) + ")")
    print(f"{label} {config} small model ({cpu.cfg['model']['max_disp']} "
          f"disps, {shape}), card vs CPU plain versions: "
          + "; ".join(report))


def family_slice_phase(smi, label, configs, pad, units, bf16_units, argmins,
                       n_disps, seed, held, prepare=None, check=None):
    """Inference at full width for each of ``configs`` in float32 and
    bfloat16 over three random 375x1242 pairs padded to ``pad``
    (family_forward, ``prepare`` drawing the weights), the
    bfloat16-vs-float32 gap on the same weights: every disparity within
    BF16_GAP_ATOL, and the gap of the disparities ``held`` (indices of
    those the trunk's units move at random weights) above 0, so that the
    bfloat16 trunk ran and made a difference; then ``check(config, pairs,
    {suffix: disparities})``. Returns the float32 and bfloat16 launch
    counts."""
    rng = np.random.RandomState(seed)
    pairs = random_pairs(rng, PAIRS, IMAGE)
    launches = {"_f32": {}, "_bf16": {}}
    for config in configs:
        runs = {}
        for suffix in ("_f32", "_bf16"):
            disps, counts, bf16, ms, parts, peak = family_forward(
                config + suffix, pairs, pad, units, bf16_units, argmins,
                n_disps[config], prepare)
            runs[suffix] = disps
            for k, v in counts.items():
                launches[suffix][k] = launches[suffix].get(k, 0) + v
            print(f"{label} {config + suffix}: inference_stereo over "
                  f"{len(pairs)} pairs {IMAGE} padded to {pad}, "
                  f"{len(disps[0])} disparities each, finite; launches "
                  f"{counts} (bf16 route {bf16}); forward {ms:.2f} ms "
                  f"(median of {FORWARD_REPS}, CUDA events), by layer "
                  + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
                  + f" ms; peak {peak:.2f} GiB at batch 1; {smi}")
        gaps = [[float(np.abs(a - b).mean()) for a, b in zip(da, db)]
                for da, db in zip(runs["_f32"], runs["_bf16"])]
        print(f"{label} {config}: bf16 vs float32 on the same weights (seed "
              f"0), mean |gap| by disparity over the pairs: "
              + "; ".join(", ".join(f"{x:.4f}" for x in g) for g in gaps)
              + f" px (each within BF16_GAP_ATOL {BF16_GAP_ATOL}; the "
              f"trunk's {list(held)} above 0)")
        assert np.isfinite(gaps).all() and np.max(gaps) <= BF16_GAP_ATOL, \
            gaps
        assert min(max(g[i] for i in held) for g in gaps) > 0, gaps
        if check is not None:
            check(config, pairs, runs)
    return launches["_f32"], launches["_bf16"]


def gcnet_phase(smi, gen, stats, bf16_trunk, launches, bf16_launches):
    """Phase 11, GCNet: fault 9 (c19 at the eval's raw volume), its units
    on the kernels at its shapes, inference at full width, a small model
    against the CPU, tools/test.main over the SceneFlow-layout set at
    544x960 batch 4 against batch 1, train_matcher at 1x256x512; its
    launches join each dtype's counts and its kernel numbers the rows."""
    for row, extra in fault9_phase(smi, gen).items():
        (bf16_trunk if row.endswith("pack1") else stats[row]).update(extra)
    for row, extra in check_family_units(
            "gcnet", gc_unit_shapes(192, 624), gen,
            train=(gc_unit_shapes(128, 256), 1)).items():
        (bf16_trunk if row.endswith("pack1") else stats[row]).update(extra)
    runs = [family_slice_phase(smi, "gcnet", (GC_CONFIG,), PADDED, GC_UNITS,
                               GC_BF16_UNITS, 1, {GC_CONFIG: 1}, 11, (0,))]
    small_card_vs_cpu("gcnet", GC_CONFIG, GC_SMALL, (64, 128), 1)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        ann, items = write_sceneflow_dataset(root)
        runs.append(family_eval_phase(smi, root, ann, items, GC_CONFIG,
                                      GC_UNITS, 1, 1, GC_BF16_UNITS))
    torch.cuda.empty_cache()
    for suffix, units in (("_f32", GC_UNITS), ("_bf16", GC_BF16_UNITS)):
        counts = family_train_phase(smi, GC_CONFIG + suffix, TRAIN_STEPS,
                                    units=units, argmins=1,
                                    keys=["l1_loss_lvl0"])
        runs.append((counts, {}) if suffix == "_f32" else ({}, counts))
        torch.cuda.empty_cache()
    for f32_counts, bf16_counts in runs:
        for total, counts in ((launches, f32_counts),
                              (bf16_launches, bf16_counts)):
            for name, n in counts.items():
                total[name] += n


def deeppruner_phase(smi, gen, stats, bf16_trunk, launches, bf16_launches):
    """Phase 12, DeepPruner 4x and 8x: its units on the kernels at the 4x
    shapes, inference at full width (384x1280), a small 4x and 8x model
    against the CPU, tools/test.main over the SceneFlow-layout set (4x at its
    544x960, 8x at 576x960) at batch 4 against batch 1, train_matcher at
    5x256x512; its launches join each dtype's counts and its kernel
    numbers the rows."""
    h, w = DP_PADDED[0] // 4, DP_PADDED[1] // 4
    for row, extra in check_family_units(
            "deeppruner", dp_unit_shapes(h, w), gen,
            train=(dp_unit_shapes(64, 128), 5)).items():
        (bf16_trunk if row.endswith("pack1") else stats[row]).update(extra)
    n_disps = {DP_CONFIGS[0]: 4, DP_CONFIGS[1]: 5}
    # the trunk's disparities: the predicted range (min, max). At seed 0
    # the refined and 'post' disparities of a model can sit at 0 after
    # their ReLUs in both dtypes (8x: gap 0.0000)
    runs = [family_slice_phase(smi, "deeppruner", DP_CONFIGS, DP_PADDED,
                               DP_UNITS, DP_BF16_UNITS, 0, n_disps, 12,
                               (-2, -1))]
    for config in DP_CONFIGS:
        small_card_vs_cpu("deeppruner", config, DP_SMALL, (64, 128),
                          n_disps[config])
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        ann, items = write_sceneflow_dataset(root)
        for config in DP_CONFIGS:
            runs.append(family_eval_phase(
                smi, root, ann, items, config, DP_UNITS, 0, n_disps[config],
                DP_BF16_UNITS, DP_EVAL_OVERRIDES.get(config),
                DP_BF16_EVAL_ATOL))
            torch.cuda.empty_cache()
    for config, steps in zip(DP_CONFIGS, (TRAIN_STEPS, 2)):
        keys = [f"l1_loss_lvl{i}" for i in range(n_disps[config])] + [
            "quantile_loss"]
        for suffix, units in (("_f32", DP_UNITS), ("_bf16", DP_BF16_UNITS)):
            counts = family_train_phase(smi, config + suffix, steps,
                                        units=units, argmins=0, keys=keys)
            runs.append((counts, {}) if suffix == "_f32" else ({}, counts))
            torch.cuda.empty_cache()
    for f32_counts, bf16_counts in runs:
        for total, counts in ((launches, f32_counts),
                              (bf16_launches, bf16_counts)):
            for name, n in counts.items():
                total[name] += n


# AnyNet at full width (the shipped config is the reference's whole model,
# 46,965 parameters): three stages at 1/16, 1/8 and 1/4 (12, 5 and 5
# samples), 15 pre-norm aggregator units with Co > 1 a forward on K1 / K4
# (none in two Ci slices) and three soft-argmins on K2, the SPN scan over
# the 1/4 map's columns as a plain loop. Its frames' sides must be
# multiples of 16 (384x1248, 544x960).
AN_CONFIG = "AnyNet/scene_flow"
AN_UNITS, AN_ARGMINS, AN_DISPS = 15, 3, 4
# At its seeded weights AnyNet's costs are nearly flat: each stage's
# soft-argmin returns about the middle of its range (88 px for
# init_guess, the warp stages the upsampled 88 plus a residual near 0),
# whatever the trunk computes. The phases that read its disparities
# draw BN and the conv biases as the CPU tests do (damp_bn; biases 0.1
# N(0, 1)) and scale each stage's last unit (Co = 1) by AN_PEAK, which
# peaks the costs. At 384x1248 the stages then sit 8-10 px from the
# middle with 2 px of spread over the frame (the seeded weights: 0.03 and
# 0.02 px), and bfloat16 moves them by 0.06 px (seeded: 0.0006-0.0009).
AN_PEAK = 30.0
AN_MID = 88.0        # px: init_guess's range's middle, 16 x (0 + 11) / 2
AN_OFFSET = 5.0      # px: each stage's mean |d - AN_MID|, at least
AN_SPREAD = 1.0      # px: each stage's std over the frame, at least
AN_GAP_FLOOR = 0.5   # the card's bfloat16 - float32 gap of each stage,
                     # at least this share of the CPU's own


def peak_anynet(module, seed=13):
    """Draw ``module``'s (an AnyNet) BN and conv biases and scale its
    stages' last units by AN_PEAK, from ``seed``, on any device. Returns
    the module."""
    from densematchingbenchmark_tpu_torch.models.anynet import STAGES
    damp_bn(module, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)) and \
                    m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
        for st in STAGES:
            getattr(module, f"agg_{st}").ConvUnit_5.Conv_0.weight.mul_(
                AN_PEAK)
    return module


def check_anynet_peaked(config, pairs, runs):
    """The stages' float32 disparities (1, 2, 3) of each pair away from
    the range's middle (mean |d - AN_MID| at least AN_OFFSET px) and
    spread over the frame (std at least AN_SPREAD px). On the first pair,
    against the same weights through the plain versions on the CPU: every
    float32 disparity within CPU_ATOL px, and each stage's
    bfloat16-vs-float32 gap on the card at least AN_GAP_FLOOR of the
    CPU's own."""
    from densematchingbenchmark_tpu_torch.apis import (inference_stereo,
                                                       init_model)
    stages = (1, 2, 3)
    spread = [[(float(np.abs(ds[i] - AN_MID).mean()), float(ds[i].std()))
               for i in stages] for ds in runs["_f32"]]
    cpu = {}
    for suffix in runs:
        model = init_model(config + suffix, device="cpu", seed=0)
        peak_anynet(model.module)
        cpu[suffix] = inference_stereo(model, pairs[:1],
                                       pad_to_shape=PADDED)[0]["disps"]
    gap = lambda r, i: float(np.abs(r["_bf16"][i] - r["_f32"][i]).mean())
    first = {k: v[0] for k, v in runs.items()}
    card, own = [gap(first, i) for i in stages], [gap(cpu, i) for i in stages]
    err = max(float(np.abs(a - b).max()) for a, b in zip(first["_f32"],
                                                          cpu["_f32"]))
    print(f"anynet {config} stages (mean |d - {AN_MID:g}|, std) px by pair: "
          + "; ".join(", ".join(f"({o:.2f}, {d:.2f})" for o, d in p)
                      for p in spread)
          + f" (at least {AN_OFFSET:g}, {AN_SPREAD:g}); first pair: float32 "
          f"card vs CPU {err:.3g} px max (tolerance {CPU_ATOL}), bf16 - "
          "float32 mean gap, card " + ", ".join(f"{g:.4f}" for g in card)
          + ", CPU " + ", ".join(f"{g:.4f}" for g in own)
          + f" px (the card's at least {AN_GAP_FLOOR:g} of the CPU's)")
    assert all(o >= AN_OFFSET and d >= AN_SPREAD for p in spread
               for o, d in p), spread
    assert err <= CPU_ATOL, err
    assert all(c >= AN_GAP_FLOOR * o for c, o in zip(card, own)), (card, own)


def an_unit_shapes(h, w):
    """(Cin, Cout, (D, H, W), units) of AnyNet's 15 aggregator units on a
    frame of h x w: init_guess at 1/16 (12 samples), warp_level_8 at 1/8
    and warp_level_4 at 1/4 (5 samples each)."""
    return ((8, 16, (12, h // 16, w // 16), 1),
            (16, 16, (12, h // 16, w // 16), 4),
            (4, 4, (5, h // 8, w // 8), 5),
            (2, 4, (5, h // 4, w // 4), 1),
            (4, 4, (5, h // 4, w // 4), 4))


def check_anynet_argmins(gen):
    """K2 at AnyNet's three costs of a 384x1248 frame (init_guess 12
    samples from 0 at 1/16, the warp stages 5 from -2 at 1/8 and 1/4),
    forward and backward against the plain version and its autograd;
    each timed (one call, chained, the plain version) beside its bound
    (bytes), summed over a forward. Returns the K2 row's extra keys."""
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    from densematchingbenchmark_tpu_torch.ops.cost_volume import (
        disp_sample_values)
    from densematchingbenchmark_tpu_torch.ops.cuda import (
        fused_soft_argmin, soft_argmin_plain)
    h, w = PADDED
    tot = dict.fromkeys(("ms", "chained_ms", "plain_ms", "bound_ms",
                         "max_abs_err"), 0.0)
    for d, start, scale in ((12, 0, 16), (5, -2, 8), (5, -2, 4)):
        vals = torch.as_tensor(disp_sample_values(d, start), device="cuda")
        cost = (torch.randn((1, d, h // scale, w // scale), device="cuda",
                            generator=gen) * 3).requires_grad_()
        kernels.reset_launch_counts()
        got = fused_soft_argmin(cost, d, start)
        g = torch.randn_like(got)
        (gc,) = torch.autograd.grad(got, cost, g)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["fused_soft_argmin"] == 1
        assert kernels.launch_counts()["fused_soft_argmin_backward"] == 1
        want = soft_argmin_plain(cost, vals)
        (wc,) = torch.autograd.grad(want, cost, g)
        err = (got - want).abs().max().item()
        assert err <= ARGMIN_ATOL, (d, start, err)
        assert (gc - wc).abs().max().item() <= \
            ARGMIN_GRAD_RTOL * wc.abs().max().item(), (d, start)
        c = cost.detach()
        call = lambda: fused_soft_argmin(c, d, start)
        times = {"ms": time_ms(call), "chained_ms": chained_ms(call),
                 "plain_ms": time_ms(lambda: soft_argmin_plain(c, vals)),
                 "bound_ms": bound_ms(6 * c.numel(), 4 * (
                     c.numel() + d + c[:, 0].numel()))[0]}
        print(f"anynet K2 {list(c.shape)} from {start}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
              + f"; max_abs_err {err:.3g} px (backward within "
              "ARGMIN_GRAD_RTOL of the plain autograd)")
        for k, v in times.items():
            tot[k] += v
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        del cost, got, gc, want, wc, c
    print("anynet K2 per forward (3 launches): " + ", ".join(
        f"{k} {v:.4g}" for k, v in tot.items()))
    return {"anynet_unit": "per forward (3 launches, 384x1248 batch 1)",
            **{f"anynet_{k}": v for k, v in tot.items()}}


def anynet_profile_phase():
    """AnyNet's forward at 384x1248 batch 1 in each dtype: device ms by
    layer (CUDA events, median of 3 after a warm-up: the backbone, each
    stage's volume + aggregator + soft-argmin, the refinement and its SPN
    scan alone), the kernel launches of the forward and of the scan
    (torch.profiler), and the scan alone on the forward's inputs, forward
    and with its backward."""
    from densematchingbenchmark_tpu_torch.apis import init_model
    from densematchingbenchmark_tpu_torch.models.refinement import \
        anynet as refinement
    scan = refinement.gate_recurrent_2d
    pair = random_pairs(np.random.RandomState(13), 1, IMAGE)[0]
    for suffix in ("_f32", "_bf16"):
        name = AN_CONFIG + suffix
        model = init_model(name, seed=0)
        module = model.module
        left, right = padded_input(model, pair)
        marks, inputs = [], []

        def timed(label, fn):
            def wrapped(*args, **kwargs):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                marks.append((label, start, end))
                if label == "spn scan":
                    inputs[:] = [a.detach() for a in args]
                return out
            return wrapped

        stage = module._stage
        module._stage = lambda st, *a: timed(f"stage {st}", stage)(st, *a)
        module.backbone.forward = timed("backbone", module.backbone.forward)
        module.disp_refinement.forward = timed(
            "refinement", module.disp_refinement.forward)
        refinement.gate_recurrent_2d = timed("spn scan", scan)
        runs = []
        try:
            with torch.inference_mode():
                for _ in range(4):
                    marks.clear()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    model.forward(left, right)
                    end.record()
                    end.synchronize()
                    parts = {"forward": start.elapsed_time(end)}
                    for label, a, b in marks:
                        parts[label] = a.elapsed_time(b)
                    runs.append(parts)
        finally:
            refinement.gate_recurrent_2d = scan
            del module._stage, module.backbone.forward, \
                module.disp_refinement.forward
        parts = {k: float(np.median([r[k] for r in runs[1:]]))
                 for k in runs[1]}
        share = parts["spn scan"] / parts["forward"]
        print(f"profile {name} forward 1x{PADDED[0]}x{PADDED[1]} by layer "
              "(device ms, CUDA events, median of 3): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in parts.items())
              + f"; the scan's share {share:.1%}")
        with torch.inference_mode():
            device_profile(f"{name} forward 1x{PADDED[0]}x{PADDED[1]}",
                           lambda: model.forward(left, right), top=12)
            device_profile(f"{name} SPN scan alone {tuple(inputs[0].shape)}",
                           lambda: scan(*inputs), top=6)
        grads = [t.clone().requires_grad_() for t in inputs]
        device_profile(f"{name} SPN scan forward + backward",
                       lambda: scan(*grads).sum().backward(), top=8)
        del model, module, inputs, grads
        torch.cuda.empty_cache()


def anynet_phase(smi, gen, stats, bf16_trunk, launches, bf16_launches):
    """Phase 13, AnyNet: its 15 pre-norm units on the kernels at the
    384x1248 shapes (K4's training route at the 6x256x512 crop), K2 at
    its three costs, inference at full width (384x1248), a small model
    against the CPU, tools/test.main over the SceneFlow-layout set at
    544x960 batch 4 against batch 1 (the three on peak_anynet's weights),
    train_matcher at 6x256x512; its launches join each dtype's counts and
    its kernel numbers the rows."""
    for row, extra in check_family_units(
            "anynet", an_unit_shapes(*PADDED), gen, bias=True,
            pre_norm=True, train=(an_unit_shapes(256, 512), 6)).items():
        (bf16_trunk if row.endswith("pack1") else stats[row]).update(extra)
    stats["fused_soft_argmin"].update(check_anynet_argmins(gen))
    # the trunk's disparities: the three stages' (the refined one as well
    # at random weights, but its residual may sit at 0 after the ReLU),
    # on weights that peak the costs (peak_anynet)
    runs = [family_slice_phase(smi, "anynet", (AN_CONFIG,), PADDED,
                               AN_UNITS, AN_UNITS, AN_ARGMINS,
                               {AN_CONFIG: AN_DISPS}, 13, (1, 2, 3),
                               peak_anynet, check_anynet_peaked)]
    if "--profile" in sys.argv[1:]:
        anynet_profile_phase()
    small_card_vs_cpu("anynet", AN_CONFIG, {}, (64, 128), AN_DISPS,
                      peak_anynet, refined=(0,))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        ann, items = write_sceneflow_dataset(root)
        runs.append(family_eval_phase(smi, root, ann, items, AN_CONFIG,
                                      AN_UNITS, AN_ARGMINS, AN_DISPS,
                                      prepare=peak_anynet))
    torch.cuda.empty_cache()
    keys = [f"l1_loss_lvl{i}" for i in range(AN_DISPS)]
    for suffix in ("_f32", "_bf16"):
        counts = family_train_phase(smi, AN_CONFIG + suffix, TRAIN_STEPS,
                                    units=AN_UNITS, argmins=AN_ARGMINS,
                                    keys=keys)
        runs.append((counts, {}) if suffix == "_f32" else ({}, counts))
        torch.cuda.empty_cache()
    for f32_counts, bf16_counts in runs:
        for total, counts in ((launches, f32_counts),
                              (bf16_launches, bf16_counts)):
            for name, n in counts.items():
                total[name] += n


# ------------------------------------------------------------------ flow
# Phase 14: optical flow. PWCFlow and RAFT at full width (the shipped
# FlyingChairs configs, random weights from seed 0) on FlyingChairs'
# 384x512 frames, batch 1; none of K1-K5 on their paths (the counters
# are read across the phase).
FLOW_CONFIGS = ("PWCFlow/flying_chairs", "RAFT/flying_chairs")
FLOW_FRAME = (384, 512)
FLOW_NFLOWS = {"PWCFlow/flying_chairs": 5, "RAFT/flying_chairs": 9}
# a FlyingChairs-layout set written here: 16 pairs train (batch 8, two
# steps an epoch), the first 4 the eval phase's test set, the first 2
# the training's per-epoch eval and vis set
FLOW_PAIRS, FLOW_TEST, FLOW_TRAIN_EVAL = 16, 4, 2
# the small models of the card-vs-CPU checks (tests/flow_parity.py's),
# on 64x96 pairs
FLOW_SMALL = {
    "PWCFlow/flying_chairs": {"model.chans": (8, 16, 16), "model.radius": 2,
                              "model.hidden": 16,
                              "model.losses.flow_l1_loss.weights":
                              (1.0, 1.0, 0.5, 0.25)},
    "RAFT/flying_chairs": {"model.iters": 2, "model.hidden": 32,
                           "model.context": 16,
                           "model.losses.flow_l1_loss.weights":
                           (1.0, 1.0, 0.8)},
}
FLOW_SMALL_FRAME = (64, 96)
# At seeded weights PWCFlow's score heads are flat: every soft-argmax
# returns about 0 and its best flow stays near 0.1 px, which bfloat16 or a
# dropped level would not move. The phases that read the flows draw BN
# and the conv biases as the CPU tests do (damp_bn; biases 0.1 N(0, 1))
# and scale each FlowEstimator's score conv (ConvUnit_2) by
# FLOW_SCORE_GAIN (tests/flow_parity.py's SCORE_GAIN); RAFT gets the same
# BN and biases.
FLOW_SCORE_GAIN = 8.0
FLOW_MIN_MAG = 1.0   # px: the best flow's mean |flow|, at least
FLOW_GAP_RATIO = (0.8, 1.25)   # the card's bf16 - float32 gap over the
                               # CPU's own on the same weights


def peak_flow(module, seed=13):
    """Draw ``module``'s (PWCFlow or RAFT) BN and conv biases from
    ``seed`` and scale PWCFlow's score convs by FLOW_SCORE_GAIN, on any
    device. Returns the module."""
    damp_bn(module, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
        for est in getattr(module, "FlowEstimator", ()):
            est.ConvUnit_2.Conv_0.weight.mul_(FLOW_SCORE_GAIN)
    return module


def write_chairs_dataset(root, n=FLOW_PAIRS):
    """A FlyingChairs-layout set under ``root``: frames as binary PPM
    (data/<i>_img1.ppm, _img2.ppm, 384x512, uint8), ground truth as .flo
    (SyntheticFlowDataset's exact flow, |u|, |v| <= 8), annotation JSONs
    (train: all pairs; test: the first FLOW_TEST; eval: the first
    FLOW_TRAIN_EVAL), half the items naming their GT 'flow_path' (the
    reference's spelling). Returns {split: annfile}."""
    from densematchingbenchmark_tpu_torch.data import io as tio
    from densematchingbenchmark_tpu_torch.flow import (SyntheticFlowDataset,
                                                       save_flo)
    h, w = FLOW_FRAME
    ds = SyntheticFlowDataset(length=n, height=h, width=w, max_flow=8,
                              seed=3)
    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    items = []
    for i in range(n):
        s = ds[i]
        stem = f"data/{i:05d}"
        for k, suffix in (("leftImage", "_img1.ppm"),
                          ("rightImage", "_img2.ppm")):
            tio.save_pnm(os.path.join(root, stem + suffix),
                         np.clip(np.rint(s[k]), 0, 255).astype(np.uint8))
        save_flo(os.path.join(root, stem + "_flow.flo"), s["flow"])
        items.append({"left_image_path": stem + "_img1.ppm",
                      "right_image_path": stem + "_img2.ppm",
                      ("flow_path" if i % 2 else "flow_map_path"):
                      stem + "_flow.flo"})
    anns = {}
    for split, m in (("train", n), ("test", FLOW_TEST),
                     ("eval", FLOW_TRAIN_EVAL)):
        anns[split] = os.path.join(root, f"{split}.json")
        with open(anns[split], "w") as fp:
            json.dump(items[:m], fp)
    return anns


def count_launches(fn):
    """(kernel launches, device busy ms) of one call of ``fn`` after one
    call outside the profile (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.device_type.name == "CUDA"]
    return (sum(e.count for e in rows),
            sum(e.self_device_time_total for e in rows) / 1e3)


def flow_inference_phase(smi, root):
    """Each flow config at full width in float32 and bfloat16, on
    peak_flow's weights, through init_flow_model + inference_flow over
    the first two written pairs (read by data/io's PPM reader): the
    flows' count and shapes, finite, the best flow's mean |flow| at least
    FLOW_MIN_MAG; a forward's ms (median of single forwards, CUDA
    events), launches, device busy ms (torch.profiler) and peak. On the
    first pair the bfloat16 - float32 mean gap of the best flow on the
    card within FLOW_GAP_RATIO of the CPU's own (the same weights through
    the plain versions)."""
    from densematchingbenchmark_tpu_torch.apis import (inference_flow,
                                                       init_flow_model)
    from densematchingbenchmark_tpu_torch.data import io as tio
    from densematchingbenchmark_tpu_torch.flow import transforms as ftrans
    pairs = [{"leftImage": tio.load_image(os.path.join(
                  root, f"data/{i:05d}_img1.ppm")),
              "rightImage": tio.load_image(os.path.join(
                  root, f"data/{i:05d}_img2.ppm"))} for i in range(2)]
    h, w = FLOW_FRAME
    for name in FLOW_CONFIGS:
        best = {}
        for suffix in ("_f32", "_bf16"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            model = init_flow_model(name + suffix, seed=0)
            peak_flow(model.module)
            out = inference_flow(model, pairs)
            flows = [r["flows"] for r in out]
            shapes = [f.shape for f in flows[0]]
            n = FLOW_NFLOWS[name]
            assert len(shapes) == n, (name, shapes)
            if name.startswith("PWC"):
                assert shapes == [(1, h, w, 2)] + [
                    (1, h >> k, w >> k, 2) for k in range(1, 5)], shapes
            else:
                assert shapes == [(1, h, w, 2)] * n, shapes
            assert all(np.isfinite(f).all() for fl in flows for f in fl)
            best[suffix] = [fl[0] for fl in flows]
            mag = [float(np.abs(f).mean()) for f in best[suffix]]
            assert min(mag) >= FLOW_MIN_MAG, (name + suffix, mag)
            s = ftrans.normalize(pairs[0], model.cfg["data"]["mean"],
                                 model.cfg["data"]["std"])
            l, r = (torch.from_numpy(s[k])[None].cuda()
                    for k in ("leftImage", "rightImage"))
            ms = time_ms(lambda: model.forward(l, r), reps=FORWARD_REPS)
            launches, busy = count_launches(lambda: model.forward(l, r))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"flow {name}{suffix}: {n} flows {shapes[0]}..{shapes[-1]}"
                  f", finite, best flow's mean |flow| "
                  f"{', '.join(f'{m:.3f}' for m in mag)} px (at least "
                  f"{FLOW_MIN_MAG:g}); forward {h}x{w} b1 "
                  f"{ms:.3f} ms (median of {FORWARD_REPS}, CUDA events), "
                  f"{launches} launches, device busy {busy:.3f} ms, peak "
                  f"{peak:.3f} GiB; {smi}")
            del model
        cpu = {}
        for suffix in best:
            model = init_flow_model(name + suffix, device="cpu", seed=0)
            peak_flow(model.module)
            cpu[suffix] = inference_flow(model, pairs[:1])[0]["flows"][0]
            del model
        err = float(np.abs(best["_f32"][0] - cpu["_f32"]).max())
        gap = float(np.abs(best["_bf16"][0] - best["_f32"][0]).mean())
        own = float(np.abs(cpu["_bf16"] - cpu["_f32"]).mean())
        lo, hi = FLOW_GAP_RATIO
        print(f"flow {name}: first pair, float32 card vs CPU {err:.3g} px "
              f"max (tolerance {CPU_ATOL}); bf16 - f32 mean gap of the best "
              f"flow, card {gap:.4f} px, CPU {own:.4f} px (the card's "
              f"{lo:g}-{hi:g} times the CPU's)")
        assert err <= CPU_ATOL, (name, err)
        assert lo * own <= gap <= hi * own + 1e-3, (name, gap, own)


def flow_small_models(name, dtype):
    """(cfg, CPU module, card module) of the small ``name`` model from
    seed 0 on peak_flow's weights."""
    from densematchingbenchmark_tpu_torch.configs import get_config
    from densematchingbenchmark_tpu_torch.models import build_model
    cfg = get_config(f"{name}_{dtype}", **FLOW_SMALL[name])
    cpu = peak_flow(build_model(cfg, torch.Generator().manual_seed(0)), 0)
    return cfg, cpu, copy.deepcopy(cpu).cuda()


def flow_card_vs_cpu_phase():
    """The small PWCFlow and RAFT on the card against the CPU (the plain
    PyTorch versions) from the same peaked weights: every flow of an eval
    forward (float32 within CPU_ATOL px max, bfloat16 within
    BF16_CPU_ATOL px mean, the CPU's own bf16 - float32 gap beside it;
    the CPU's best float32 flow at least FLOW_MIN_MAG px mean), and one
    float32 train step's losses (within TRAIN_LOSS_RTOL) and
    per-parameter gradients (cosine above TRAIN_GRAD_COS)."""
    from densematchingbenchmark_tpu_torch.apis import StereoModel
    from densematchingbenchmark_tpu_torch.flow import flow_l1_loss
    from densematchingbenchmark_tpu_torch.losses import total_loss
    h, w = FLOW_SMALL_FRAME
    rng = np.random.RandomState(0)
    ref = rng.randn(2, h, w, 3).astype(np.float32)
    tgt = (np.roll(ref, (1, 2), axis=(1, 2))
           + 0.1 * rng.randn(2, h, w, 3)).astype(np.float32)
    gt = (rng.randn(2, h, w, 2) + (2.0, 1.0)).astype(np.float32)
    batch = {k: torch.from_numpy(v) for k, v in
             (("leftImage", ref), ("rightImage", tgt), ("flow", gt))}
    cpu_dev = torch.device("cpu")
    for name in FLOW_CONFIGS:
        cpu_f32 = None
        for dtype in ("f32", "bf16"):
            cfg, cpu, card = flow_small_models(name, dtype)
            got = StereoModel(cfg, card.eval(), torch.device("cuda")).forward(
                batch["leftImage"].cuda(), batch["rightImage"].cuda())
            want = StereoModel(cfg, cpu.eval(), cpu_dev).forward(
                batch["leftImage"], batch["rightImage"])
            diffs = [(g.cpu() - wt).abs() for g, wt in
                     zip(got["flows"], want["flows"])]
            if dtype == "f32":
                cpu_f32 = want["flows"]
                mag = float(cpu_f32[0].abs().mean())
                err = max(float(d.max()) for d in diffs)
                note = f"; the CPU's best flow mean |flow| {mag:.3f} px"
                assert mag >= FLOW_MIN_MAG, (name, mag)
                assert err <= CPU_ATOL, (name, err)
            else:
                err = max(float(d.mean()) for d in diffs)
                note = "; the CPU's own bf16 - f32 mean gap " + ", ".join(
                    f"{float((a - b).abs().mean()):.4f}"
                    for a, b in zip(want["flows"], cpu_f32)) + " px"
                assert err <= BF16_CPU_ATOL, (name, err)
            print(f"flow card vs CPU {name}_{dtype} small, 2x{h}x{w}: "
                  f"{len(diffs)} flows, {'max' if dtype == 'f32' else 'mean'}"
                  f" |card - CPU| {err:.3g} px (within "
                  f"{CPU_ATOL if dtype == 'f32' else BF16_CPU_ATOL}){note}")
            if dtype != "f32":
                continue
            weights = cfg["model"]["losses"]["flow_l1_loss"]["weights"]
            res = []
            for module in (card, cpu):
                device = next(module.parameters()).device
                module.train()
                out = module(batch["leftImage"].to(device),
                             batch["rightImage"].to(device))
                ld = flow_l1_loss(out["flows"], batch["flow"].to(device),
                                  weights)
                loss = total_loss(ld)
                grads = torch.autograd.grad(loss, list(module.parameters()))
                res.append(({k: float(v.detach()) for k, v in ld.items()},
                            [g.cpu() for g in grads]))
            (m_card, g_card), (m_cpu, g_cpu) = res
            loss_err = max(abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k])
                           for k in m_cpu)
            assert loss_err <= TRAIN_LOSS_RTOL, (name, m_card, m_cpu)
            # a conv bias before a batch-statistics BN: its gradient is 0
            # up to rounding, on both sides
            zero = {f"{mn}.Conv_0.bias" for mn, m in cpu.named_modules()
                    if getattr(m, "BatchNorm_0", None) is not None
                    and not m.pre_norm and m.Conv_0.bias is not None}
            top = max(float(g.abs().max()) for g in g_cpu)
            worst = 1.0
            for (pn, _), ga, gc in zip(cpu.named_parameters(), g_card,
                                       g_cpu):
                if pn in zero:
                    assert max(float(ga.abs().max()), float(
                        gc.abs().max())) <= 1e-5 * top, (name, pn)
                    continue
                cos = float((ga * gc).sum() / (ga.norm() * gc.norm()))
                assert cos > TRAIN_GRAD_COS, (name, pn, cos)
                worst = min(worst, cos)
            print(f"flow same weights {name}_f32 small, train step card vs "
                  f"CPU: losses rel err {loss_err:.3g} (within "
                  f"{TRAIN_LOSS_RTOL}), worst gradient cosine {worst:.6f} "
                  f"(the {len(zero)} conv biases before a batch BN within "
                  f"1e-5 of the largest gradient)")


def flow_metrics_f64(est, gt):
    """EPE and the 1 / 2 / 3 / 5 px shares (%) of one sample, in float64
    numpy, NaN GT masked (flow/metrics.calc_flow_error's definition);
    ``est`` cropped to the GT's size (the eval's padding has NaN GT)."""
    est = est[:gt.shape[0], :gt.shape[1]].astype(np.float64)
    gt = gt.astype(np.float64)
    mask = ~np.isnan(gt).any(-1)
    epe = np.sqrt(((est - np.nan_to_num(gt)) ** 2).sum(-1))[mask]
    out = {f"{t}px": 100.0 * float((epe > t).mean()) for t in (1, 2, 3, 5)}
    out["epe"] = float(epe.mean())
    return out


def flow_eval_phase(smi, root, ann):
    """tools/test.main on each flow config in both dtypes over the written
    set's FLOW_TEST pairs at 384x512 (frames through the PPM reader, GT
    .flo) on peak_flow's weights (a checkpoint in --work-dir the tool
    restores), --out-dir writing each sample's best flow: the tool's EPE and
    n-px against float64 host metrics of the written flows against the
    GT (EPE within EVAL_EPE_ATOL px, each share within EVAL_PX_ATOL
    points); the tool's wall time a sample (host clock: decode, model
    set-up excluded) and peak memory."""
    from densematchingbenchmark_tpu_torch.apis import init_flow_model
    from densematchingbenchmark_tpu_torch.flow import load_flo
    from densematchingbenchmark_tpu_torch.tools import test as ttest
    from densematchingbenchmark_tpu_torch.utils.checkpoint import \
        CheckpointManager
    with open(ann) as fp:
        items = json.load(fp)
    gts = [load_flo(os.path.join(root, it.get("flow_map_path")
                                 or it["flow_path"])) for it in items]
    for name in FLOW_CONFIGS:
        for suffix in ("_f32", "_bf16"):
            with tempfile.TemporaryDirectory() as work:
                module = peak_flow(init_flow_model(
                    name + suffix, device="cpu", seed=0).module)
                CheckpointManager(work).save(
                    0, {"module": module.state_dict()})
                del module
                out_dir = os.path.join(work, "out")
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    results, n = ttest.main(
                        ["--config", name + suffix, "--work-dir", work,
                         "--data-root", root, "--annfile", ann,
                         "--out-dir", out_dir])
                wall = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                assert n == len(items) == FLOW_TEST, (n, len(items))
                per = [flow_metrics_f64(load_flo(os.path.join(
                    out_dir, "flow_0", f"{i:06d}.flo")), gt)
                    for i, gt in enumerate(gts)]
            want = {k: float(np.mean([p[k] for p in per])) for k in per[0]}
            assert sorted(results) == sorted(want), results
            assert all(np.isfinite(v) for v in results.values()), results
            assert abs(results["epe"] - want["epe"]) <= EVAL_EPE_ATOL, (
                results, want)
            for k in ("1px", "2px", "3px", "5px"):
                assert abs(results[k] - want[k]) <= EVAL_PX_ATOL, (
                    k, results, want)
            print(f"flow eval {name}{suffix} (tools/test.main, {n} "
                  f"FlyingChairs-layout PPM pairs, 384x512): "
                  + ", ".join(f"{k} {results[k]:.4f}" for k in
                              sorted(results))
                  + f" (float64 host: epe {want['epe']:.4f}); "
                  f"{wall / n * 1e3:.1f} ms a sample end to end with the "
                  f"model's set-up and the --out-dir writes, peak "
                  f"{peak:.3f} GiB; {smi}")


def flow_train_phase(smi, root, anns):
    """tools/train.main on each flow config in both dtypes: the written
    set's 16 pairs cropped to the config's 320x448 at batch 8, 5 steps
    (two an epoch), after each epoch the eval of 2 pairs at 384x512 and
    the vis hook; the losses finite, the eval's EPE finite, the vis
    PNGs written; the step's ms (median of steps 2-5, host clock) and
    peak."""
    from densematchingbenchmark_tpu_torch.tools import train as ttrain
    from densematchingbenchmark_tpu_torch.trainer.loop import read_metrics
    for name in FLOW_CONFIGS:
        for suffix in ("_f32", "_bf16"):
            data = ttrain.get_config(name + suffix)["data"]
            shape = "x".join(str(v) for v in (data["batch_size_per_device"],
                                              *data["crop_size"]))
            with tempfile.TemporaryDirectory() as work:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                with contextlib.redirect_stdout(io.StringIO()):
                    state = ttrain.main(
                        ["--config", name + suffix, "--work-dir", work,
                         "--data-root", root, "--annfile", anns["train"],
                         "--eval-annfile", anns["eval"], "--max-steps",
                         str(TRAIN_STEPS), "--log-interval", "1"])
                records = read_metrics(work)
                vis = sorted(os.listdir(os.path.join(work, "vis",
                                                     "sample_001")))
            assert state.step == TRAIN_STEPS
            assert all(p.dtype == torch.float32
                       for p in state.module.parameters())
            steps = [r for r in records if "train/loss" in r]
            evals = [r for r in records if "eval/epe" in r]
            assert [r["step"] for r in steps] == list(
                range(1, TRAIN_STEPS + 1))
            assert all(np.isfinite(r["train/loss"]) for r in steps)
            assert len(evals) == 3 and all(np.isfinite(r["eval/epe"])
                                           for r in evals), evals
            assert vis == [f"flow_{k}_{e}.png" for k in ("0", "gt")
                           for e in (1, 2, 3)], vis
            step_ms = float(np.median([r["train/step_ms"]
                                       for r in steps[1:]]))
            peak = max(r.get("train/peak_mem_gib", 0.0) for r in steps)
            print(f"flow train {name}{suffix} (tools/train.main, {shape} "
                  f"crops of the PPM set, {TRAIN_STEPS} steps): losses "
                  f"{[round(r['train/loss'], 4) for r in steps]}; eval "
                  f"epe {[round(r['eval/epe'], 3) for r in evals]}; step "
                  f"{step_ms:.2f} ms (median of steps 2-{TRAIN_STEPS}, host "
                  f"clock), peak {peak:.2f} GiB; {smi}")
            del state
            torch.cuda.empty_cache()


def flow_demo_phase(root):
    """tools/demo.main on one written PPM pair (left/ frame t, right/
    frame t + 1): a .flo of the frame's size and a colour PNG."""
    from densematchingbenchmark_tpu_torch.data import io as tio
    from densematchingbenchmark_tpu_torch.flow import load_flo
    from densematchingbenchmark_tpu_torch.tools import demo as tdemo
    with tempfile.TemporaryDirectory() as work:
        for side, suffix in (("left", "_img1.ppm"), ("right", "_img2.ppm")):
            os.makedirs(os.path.join(work, side))
            with open(os.path.join(root, "data", "00000" + suffix),
                      "rb") as src, open(os.path.join(work, side,
                                                      "00000.ppm"),
                                         "wb") as dst:
                dst.write(src.read())
        out = os.path.join(work, "out")
        with contextlib.redirect_stdout(io.StringIO()):
            tdemo.main(["--config", "RAFT/flying_chairs", "--data-dir",
                        work, "--out-dir", out])
        flo = load_flo(os.path.join(out, "flow_0", "00000.flo"))
        png = tio.load_image(os.path.join(out, "color_flow", "00000.png"))
    assert flo.shape == FLOW_FRAME + (2,) and np.isfinite(flo).all()
    assert png.shape == FLOW_FRAME + (3,)
    print(f"flow demo (tools/demo.main, RAFT/flying_chairs): one PPM pair "
          f"-> .flo {flo.shape}, colour PNG {png.shape}")


def flow_profile_phase():
    """--profile: each flow config's forward at 384x512 b1 in both dtypes
    by kernel (device_profile), and PWCFlow's correlation volume alone at
    each level's shape (launches, device ms)."""
    from densematchingbenchmark_tpu_torch.apis import init_flow_model
    from densematchingbenchmark_tpu_torch.ops.cost_volume import (
        correlation2d_volume)
    h, w = FLOW_FRAME
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(2, 1, h, w, 3, device="cuda", generator=gen)
    for name in FLOW_CONFIGS:
        for suffix in ("_f32", "_bf16"):
            model = init_flow_model(name + suffix, seed=0)
            device_profile(f"flow {name}{suffix} forward {h}x{w} b1",
                           lambda: model.forward(x[0], x[1]), top=12)
            del model
    for lvl, c in enumerate((16, 32, 64, 96)):
        fm = torch.randn(2, 1, h >> (lvl + 1), w >> (lvl + 1), c,
                         device="cuda", generator=gen)
        launches, busy = count_launches(
            lambda: correlation2d_volume(fm[0], fm[1], 4))
        ms = time_ms(lambda: correlation2d_volume(fm[0], fm[1], 4))
        print(f"  correlation2d_volume level {lvl} {tuple(fm.shape[2:])} "
              f"r 4: {launches} launches, device {busy:.3f} ms, one call "
              f"{ms:.3f} ms")


def flow_phase(smi):
    """Phase 14, optical flow: inference, card vs CPU, evaluation,
    training and the demo of PWCFlow and RAFT; the port's kernels' launch
    counters must not move across it."""
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as root:
        anns = write_chairs_dataset(root)
        flow_inference_phase(smi, root)
        flow_card_vs_cpu_phase()
        torch.cuda.empty_cache()
        flow_eval_phase(smi, root, anns["test"])
        flow_train_phase(smi, root, anns)
        flow_demo_phase(root)
    if "--profile" in sys.argv[1:]:
        flow_profile_phase()
    torch.cuda.empty_cache()
    counts = kernels.launch_counts()
    assert set(counts.values()) == {0}, counts
    assert set(kernels.bf16_launch_counts().values()) == {0}
    print(f"flow phases: {time.perf_counter() - t0:.1f} s, none of the "
          f"port's kernels launched ({counts})")


# Data parallelism (phase 15): PSMNet/scene_flow at full width, its 256x512
# crop, a global batch of 6 (its batch_size_per_device 3 times 2 ranks) for
# PAR_STEPS steps; two gloo ranks on the one card against one rank at 6.
PAR_CONFIG = "PSMNet/scene_flow"
PAR_STEPS, PAR_GLOBAL = 3, 6
PAR_LOSS_RTOL = 1e-4      # float32: the first step's loss, 2 ranks vs 1
PAR_STATE_TOL = 1e-4      # float32: the BN statistics after the first step,
                          # of their largest value
PAR_GRAD_COS = 0.999      # float32: the first step's gradient of each
                          # parameter, cosine of 2 ranks' vs 1's
PAR_BF16_LOSS_RTOL = 0.01 # bfloat16: the first step's loss, 2 ranks vs 1
PAR_PERTURB = 1e-7        # the floor run's relative weight perturbation
# the NCCL rank: tools/train.main --launcher env, WORLD_SIZE 1
PAR_NCCL_STEPS, PAR_NCCL_EVAL = 2, 2


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def first_step_capture(perturb=0.0):
    """Within it, train_matcher's first step records the gradients the
    optimizer gets (summed over the ranks) and the BN statistics after
    the step; with ``perturb`` the model is built with every weight
    scaled by (1 + perturb * N(0, 1)) (seeded)."""
    from densematchingbenchmark_tpu_torch.trainer import loop, optim
    from densematchingbenchmark_tpu_torch.trainer import train_step
    first = {}
    real = (optim._Optimizer.step, train_step.apply_losses, loop.build_model)

    def step(self, grads, grad_norm=None):
        if "grads" not in first:
            first["grads"] = [g.detach().float().cpu() for g in grads]
        return real[0](self, grads, grad_norm)

    def apply_losses(state, loss_dict):
        out = real[1](state, loss_dict)
        if "buffers" not in first:
            first["buffers"] = {n: b.detach().cpu().clone()
                                for n, b in state.module.named_buffers()}
            first["names"] = [n for n, _ in state.module.named_parameters()]
        return out

    def build_model(cfg, generator=None, mesh=None):
        module = real[2](cfg, generator, mesh=mesh)
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in module.parameters():
                p.mul_(1 + perturb * torch.randn(p.shape, generator=g))
        return module

    optim._Optimizer.step, train_step.apply_losses = step, apply_losses
    if perturb:
        loop.build_model = build_model
    try:
        yield first
    finally:
        optim._Optimizer.step, train_step.apply_losses, loop.build_model = \
            real


def parallel_rank(rank, world, port, suffix, out_dir, perturb=0.0):
    """One rank of the data-parallel check: train_matcher on PAR_CONFIG +
    ``suffix`` at batch_size_per_device PAR_GLOBAL // world for PAR_STEPS
    steps on cuda:0, in a gloo group of ``world`` (none for 1). Writes its
    parameters, BN statistics, the first step's gradients and BN
    statistics, launch and collective counts and (rank 0) its losses and
    step times to <out_dir>/<world>_<rank>.pt (``perturb``: the floor
    run's weights, to <out_dir>/floor.pt)."""
    from densematchingbenchmark_tpu_torch.configs import get_config
    from densematchingbenchmark_tpu_torch.data import (SyntheticStereoDataset,
                                                       transforms)
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    from densematchingbenchmark_tpu_torch.parallel import (
        collective_counts, init_distributed, reset_collective_counts,
        shutdown_distributed)
    from densematchingbenchmark_tpu_torch.trainer import train_matcher
    from densematchingbenchmark_tpu_torch.trainer.loop import read_metrics
    if world > 1:
        init_distributed(coordinator=f"localhost:{port}",
                         num_processes=world, process_id=rank,
                         device="cuda:0", backend="gloo")
    cfg = get_config(PAR_CONFIG + suffix)
    data = cfg["data"]
    data["batch_size_per_device"] = PAR_GLOBAL // world
    cfg["vis"] = {"enabled": False}
    crop = data["train"]["input_shape"]
    ds = SyntheticStereoDataset(
        length=PAR_GLOBAL * PAR_STEPS, height=crop[0] + 32,
        width=crop[1] + 64, max_disp=cfg["model"]["max_disp"],
        transform=transforms.make_train_transform(crop, data["mean"],
                                                  data["std"]))
    with tempfile.TemporaryDirectory() as work, \
            first_step_capture(perturb) as first:
        kernels.reset_launch_counts()
        reset_collective_counts()
        torch.cuda.reset_peak_memory_stats()
        state = train_matcher(cfg, work, train_dataset=ds,
                              max_steps=PAR_STEPS, log_interval=1,
                              device="cuda:0")
        torch.cuda.synchronize()
        records = read_metrics(work) if rank == 0 else []
    result = {"params": {n: p.detach().cpu()
                         for n, p in state.module.named_parameters()},
              "buffers": {n: b.cpu() for n, b in state.module.named_buffers()},
              "first": first,
              "launches": kernels.launch_counts(),
              "bf16_launches": kernels.bf16_launch_counts(),
              "collectives": collective_counts(),
              "losses": [r["train/loss"] for r in records],
              "grad_norms": [r["train/grad_norm"] for r in records],
              "step_ms": [r["train/step_ms"] for r in records],
              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    name = "floor" if perturb else f"{world}_{rank}"
    torch.save(result, os.path.join(out_dir, f"{name}.pt"))
    shutdown_distributed()


def nccl_rank(rank, out_dir, port):
    """tools/train.main under --launcher env as the one rank of an NCCL
    group (WORLD_SIZE 1): PSMNet/scene_flow_f32 at full width on 256x512
    synthetic pairs, PAR_NCCL_STEPS steps and the per-epoch eval of
    PAR_NCCL_EVAL samples; writes its collective and launch counts."""
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    from densematchingbenchmark_tpu_torch.parallel import (
        collective_counts, reset_collective_counts)
    from densematchingbenchmark_tpu_torch.tools import train as ttrain
    from densematchingbenchmark_tpu_torch.trainer.loop import read_metrics
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    with tempfile.TemporaryDirectory() as work:
        kernels.reset_launch_counts()
        reset_collective_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            state = ttrain.main(
                ["--config", "PSMNet/scene_flow_f32", "--work-dir", work,
                 "--synthetic", "--synthetic-shape", "256", "512",
                 "--synthetic-length", str(PAR_NCCL_STEPS),
                 "--synthetic-eval", str(PAR_NCCL_EVAL), "--max-steps",
                 str(PAR_NCCL_STEPS), "--log-interval", "1",
                 "--launcher", "env"])
        records = read_metrics(work)
    assert not torch.distributed.is_initialized()    # the tool left it
    torch.save({"collectives": collective_counts(),
                "launches": kernels.launch_counts(),
                "device": str(next(state.module.parameters()).device),
                "records": records},
               os.path.join(out_dir, "nccl.pt"))


def parallel_phase(smi):
    """Phase 15, data parallelism: the gloo pair against one rank in each
    dtype, beside one rank from perturbed weights (the floor), then the
    NCCL rank; returns the launch counts of its runs (each rank's),
    float32's and bfloat16's."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    counts = {}
    with tempfile.TemporaryDirectory() as out:
        for suffix in ("_f32", "_bf16"):
            torch.cuda.empty_cache()
            # one rank at the global batch, in this process, no group
            parallel_rank(0, 1, None, suffix, out)
            torch.cuda.empty_cache()
            one = torch.load(os.path.join(out, "1_0.pt"), weights_only=False)
            parallel_rank(0, 1, None, suffix, out, perturb=PAR_PERTURB)
            torch.cuda.empty_cache()
            floor = torch.load(os.path.join(out, "floor.pt"),
                               weights_only=False)
            # two ranks on the one card, each its half of every batch
            mp.start_processes(parallel_rank,
                               args=(2, free_port(), suffix, out),
                               nprocs=2, join=True, start_method="spawn")
            two = [torch.load(os.path.join(out, f"2_{r}.pt"),
                              weights_only=False) for r in range(2)]
            counts[suffix] = check_parallel(suffix, one, two, floor, smi)
        port = free_port()
        mp.start_processes(nccl_rank, args=(out, port), nprocs=1,
                           join=True, start_method="spawn")
        nccl = torch.load(os.path.join(out, "nccl.pt"), weights_only=False)
    # per step 3 loss counts, the gradient all-reduce and the metrics'; the
    # eval's combination: a key all_gather and a sum all_reduce; the
    # module's broadcast (float32, int64); the checkpoint's barrier
    want = {"all_reduce": 5 * PAR_NCCL_STEPS + 1, "all_gather": 1,
            "broadcast": 2, "barrier": 1}
    assert nccl["collectives"] == want, nccl["collectives"]
    assert nccl["device"] == "cuda:0", nccl["device"]
    steps = [r for r in nccl["records"] if "train/loss" in r]
    evals = [r for r in nccl["records"] if "eval/disp_0/epe" in r]
    assert len(steps) == PAR_NCCL_STEPS and len(evals) == 1
    assert all(np.isfinite(r["train/loss"]) for r in steps)
    assert np.isfinite(evals[0]["eval/disp_0/epe"])
    k = nccl["launches"]
    assert k["conv3d_packed_s1"] == 13 * PAR_NCCL_STEPS and \
        k["fused_soft_argmin_backward"] == 3 * PAR_NCCL_STEPS, k
    counts["_f32"] = {n: counts["_f32"][n] + k[n] for n in k}
    print(f"parallel NCCL rank (tools/train.main --launcher env, "
          f"WORLD_SIZE 1, PSMNet/scene_flow_f32 1x256x512, "
          f"{PAR_NCCL_STEPS} steps, eval of {PAR_NCCL_EVAL}): collectives "
          f"{nccl['collectives']} as expected; losses "
          f"{[round(r['train/loss'], 4) for r in steps]}; eval EPE "
          f"{evals[0]['eval/disp_0/epe']:.4f} px; launches {k}")
    print(f"parallel phase: {time.perf_counter() - t0:.1f} s; {smi}")
    return counts["_f32"], counts["_bf16"]


def state_errors(got, want):
    """Of ``want`` (one rank's run): the first step's loss and gradient
    norm's relative errors, its BN statistics' largest error over their
    largest value and its gradients' worst cosine; each later step's
    loss's relative error; and after the last step the parameters' and BN
    statistics' largest error over their largest value."""
    def rel(a, b):
        return abs(a - b) / abs(b)

    def worst(a, b):
        names = [n for n, t in b.items() if t.is_floating_point()]
        return max(float((a[n].float() - b[n].float()).abs().max())
                   for n in names) / max(float(b[n].float().abs().max())
                                         for n in names)
    cos = min(float((g * w).sum() / (g.norm() * w.norm()))
              for g, w in zip(got["first"]["grads"], want["first"]["grads"])
              if float(w.abs().max()) > 1e-6 * max(
                  float(x.abs().max()) for x in want["first"]["grads"]))
    return {"loss_1": rel(got["losses"][0], want["losses"][0]),
            "grad_norm_1": rel(got["grad_norms"][0], want["grad_norms"][0]),
            "bn_1": worst(got["first"]["buffers"], want["first"]["buffers"]),
            "grad_cos_1": cos,
            "later_losses": [rel(a, b) for a, b in zip(got["losses"][1:],
                                                       want["losses"][1:])],
            "params": worst(got["params"], want["params"]),
            "bn": worst(got["buffers"], want["buffers"])}


def check_parallel(suffix, one, two, floor, smi):
    """The gloo pair (``two``) against one rank (``one``) at the same
    global batch, beside one rank from perturbed weights (``floor``);
    returns the launches of the pair's, the one rank's and the floor's
    runs.

    Held: the first step (its loss, gradients and BN statistics: the
    global batch's semantics, before any update). After RMSprop's first
    update (about 10 lr times the sign of every gradient element, however
    small) float32 noise in the gradients moves the parameters by whole
    updates, so later steps are printed beside the floor run's, which
    differs from the one rank's run by a 1e-7 relative perturbation of
    its weights alone."""
    bf16 = suffix == "_bf16"
    for r, res in enumerate(two):
        k = res["launches"]
        # K4 13 and K2 3 + 3 a step on every rank; in bfloat16 K4 is its
        # tensor-core route
        assert k["conv3d_packed_s1"] == 13 * PAR_STEPS and \
            k["fused_soft_argmin"] == 3 * PAR_STEPS and \
            k["fused_soft_argmin_backward"] == 3 * PAR_STEPS, (r, k)
        assert res["bf16_launches"]["conv3d_packed_s1"] == \
            (13 * PAR_STEPS if bf16 else 0), (r, res["bf16_launches"])
        assert res["collectives"]["all_reduce"] > 0, res["collectives"]
    assert set(one["collectives"].values()) == {0}, one["collectives"]
    assert two[0]["collectives"] == two[1]["collectives"]
    for n, p in two[0]["params"].items():
        assert torch.equal(p, two[1]["params"][n]), n
    for g, h in zip(two[0]["first"]["grads"], two[1]["first"]["grads"]):
        assert torch.equal(g, h)
    assert len(two[0]["losses"]) == len(one["losses"]) == PAR_STEPS
    assert np.isfinite(two[0]["losses"]).all()
    err = state_errors(two[0], one)
    if bf16:
        assert err["loss_1"] <= PAR_BF16_LOSS_RTOL, err
    else:
        assert err["loss_1"] <= PAR_LOSS_RTOL and \
            err["bn_1"] <= PAR_STATE_TOL and \
            err["grad_cos_1"] > PAR_GRAD_COS, err
    fmt = {k: ([float(f"{x:.3g}") for x in v] if isinstance(v, list)
               else float(f"{v:.4g}")) for k, v in err.items()}
    fe = state_errors(floor, one)
    floor_text = (f"; the floor (one rank, weights x (1 + 1e-7 N)): " +
                  str({k: ([float(f"{x:.3g}") for x in v]
                           if isinstance(v, list) else float(f"{v:.4g}"))
                       for k, v in fe.items()}))
    ms_one = float(np.median(one["step_ms"][1:]))
    ms_two = float(np.median(two[0]["step_ms"][1:]))
    print(f"parallel {PAR_CONFIG}{suffix}, 2 gloo ranks x "
          f"{PAR_GLOBAL // 2} on cuda:0 vs 1 rank x {PAR_GLOBAL} "
          f"(256x512, {PAR_STEPS} steps): losses "
          f"{[round(x, 4) for x in two[0]['losses']]} vs "
          f"{[round(x, 4) for x in one['losses']]}; errors {fmt}"
          f"{floor_text}; the ranks' params bitwise equal; launches per "
          f"rank {two[0]['launches']}; collectives per rank "
          f"{two[0]['collectives']}; step {ms_one:.2f} ms (1 x "
          f"{PAR_GLOBAL}) and {ms_two:.2f} ms (2 x {PAR_GLOBAL // 2} on "
          f"one card, gloo through the host; times of the check, not a "
          f"speed claim), median of steps 2-{PAR_STEPS}, host clock; peak "
          f"{one['peak_gib']:.2f} / {two[0]['peak_gib']:.2f} GiB; {smi}")
    return {n: one["launches"][n] + floor["launches"][n]
            + two[0]["launches"][n] + two[1]["launches"][n]
            for n in one["launches"]}


# The D-sharded cost volume (phase 21): PSMNet/scene_flow at full width on
# grids of gloo ranks sharing cuda:0; eval at 384x1248 on a (1, 2) grid,
# training at 256x512 on (1, 2) (global batch 3) and (2, 2) (global 2)
D_CONFIG = "PSMNet/scene_flow"
D_FRAME = (384, 1248)
D_STEPS, D_GLOBAL = 3, 3
D_GRID_STEPS, D_GRID_GLOBAL = 2, 2
D_F32_ATOL = 2e-3    # px, float32: the units on 24 + 2 planes sum each
                     # output's taps as on 48, the gathers copy; MODES_ATOL
D_BF16_ATOL = 0.05   # px, bfloat16, mean: a bfloat16 rounding that flips
                     # in a sum of another order moves the soft-argmin by
                     # a bfloat16 step of its costs (BF16_CPU_ATOL's scale)


def d_pair():
    """One normalised random 384x1248 pair, the same in every process."""
    g = torch.Generator().manual_seed(21)
    return [torch.randn((1, *D_FRAME, 3), generator=g) for _ in range(2)]


def d_eval_rank(rank, world, port, out_dir):
    """A D-split PSMNet eval forward per dtype and mode on a (1, world)
    grid on cuda:0 (world 1: the one process, no group); writes its
    disparities, launches, collectives and peak memory."""
    from densematchingbenchmark_tpu_torch.configs import get_config
    from densematchingbenchmark_tpu_torch.models import build_model
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    from densematchingbenchmark_tpu_torch.parallel import (
        collective_bytes, collective_counts, d_axis_counts, init_distributed,
        make_mesh, reset_collective_counts, shutdown_distributed)
    if world > 1:
        init_distributed(coordinator=f"localhost:{port}",
                         num_processes=world, process_id=rank,
                         device="cuda:0", backend="gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh((1, world)) if world > 1 else None
    left, right = (x.cuda() for x in d_pair())
    out = {}
    for dtype in ("f32", "bf16"):
        for fused in (False, True):
            cfg = get_config(f"{D_CONFIG}_{dtype}", **{
                "model.eval.fused_upsample_argmin": fused})
            module = build_model(cfg, torch.Generator().manual_seed(0),
                                 mesh=mesh).cuda().eval()
            with torch.inference_mode():
                module(left, right)                     # operands, warm-up
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                reset_collective_counts()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                disps = module(left, right)["disps"]
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            out[dtype, fused] = {
                "disps": [d.float().cpu() for d in disps],
                "launches": kernels.launch_counts(),
                "bf16_launches": kernels.bf16_launch_counts(),
                "collectives": collective_counts(),
                "bytes": collective_bytes(), "d_axis": d_axis_counts(),
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "ms": ms}
            del module, disps
            torch.cuda.empty_cache()
    torch.save(out, os.path.join(out_dir, f"eval{world}_{rank}.pt"))
    shutdown_distributed()


def d_train_rank(rank, world, port, grid, steps, global_batch, out_dir):
    """train_matcher on PSMNet/scene_flow_f32 with its volume split over
    ``grid`` (world 1: the one process at ``global_batch``) for ``steps``
    steps at 256x512 on cuda:0; writes the first step's gradients and BN
    statistics, the losses, the parameters, launches, the collectives of
    the second step and the peak memory."""
    from densematchingbenchmark_tpu_torch.configs import get_config
    from densematchingbenchmark_tpu_torch.data import (SyntheticStereoDataset,
                                                       transforms)
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    from densematchingbenchmark_tpu_torch.parallel import (
        collective_bytes, collective_counts, d_axis_counts, init_distributed,
        make_mesh, reset_collective_counts, shutdown_distributed)
    from densematchingbenchmark_tpu_torch.trainer import train_matcher
    from densematchingbenchmark_tpu_torch.trainer import train_step
    from densematchingbenchmark_tpu_torch.trainer.loop import read_metrics
    if world > 1:
        init_distributed(coordinator=f"localhost:{port}",
                         num_processes=world, process_id=rank,
                         device="cuda:0", backend="gloo")
    mesh = make_mesh(grid if world > 1 else None)
    cfg = get_config(PAR_CONFIG + "_f32")
    data = cfg["data"]
    data["batch_size_per_device"] = global_batch // mesh.n_data
    cfg["vis"] = {"enabled": False}
    crop = data["train"]["input_shape"]
    ds = SyntheticStereoDataset(
        length=global_batch * steps, height=crop[0] + 32,
        width=crop[1] + 64, max_disp=cfg["model"]["max_disp"],
        transform=transforms.make_train_transform(crop, data["mean"],
                                                  data["std"]))
    per_step = []
    with tempfile.TemporaryDirectory() as work, \
            first_step_capture() as first:
        real = train_step.apply_losses

        def apply_losses(state, loss_dict):     # the collectives after each
            result = real(state, loss_dict)
            per_step.append((collective_counts(), collective_bytes(),
                             d_axis_counts()))
            return result
        train_step.apply_losses = apply_losses
        try:
            kernels.reset_launch_counts()
            reset_collective_counts()
            torch.cuda.reset_peak_memory_stats()
            state = train_matcher(cfg, work, train_dataset=ds,
                                  max_steps=steps, log_interval=1,
                                  device="cuda:0", mesh=mesh,
                                  use_volume_sharding=True)
            torch.cuda.synchronize()
        finally:
            train_step.apply_losses = real
        records = read_metrics(work) if rank == 0 else []
    # the second step's collectives: the difference of the counts after it
    # and after the first
    step2 = [{k: b[k] - a[k] for k in a}
             for a, b in zip(per_step[0], per_step[1])]
    torch.save({"params": {n: p.detach().cpu()
                           for n, p in state.module.named_parameters()},
                "first": first,
                "launches": kernels.launch_counts(),
                "bf16_launches": kernels.bf16_launch_counts(),
                "step_collectives": step2,
                "losses": [r["train/loss"] for r in records],
                "grad_norms": [r["train/grad_norm"] for r in records],
                "step_ms": [r["train/step_ms"] for r in records],
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30},
               os.path.join(out_dir, f"train{world}_{rank}.pt"))
    shutdown_distributed()


def d_first_step_errors(got, want):
    """The first step's loss relative error, the BN statistics' largest
    error over their largest value and the gradients' worst cosine."""
    names = [n for n, t in want["first"]["buffers"].items()
             if t.is_floating_point()]
    a, b = got["first"]["buffers"], want["first"]["buffers"]
    top = max(float(x.abs().max()) for x in want["first"]["grads"])
    cos = min(float((g * w).sum() / (g.norm() * w.norm()))
              for g, w in zip(got["first"]["grads"], want["first"]["grads"])
              if float(w.abs().max()) > 1e-6 * top)
    return {"loss_1": abs(got["losses"][0] - want["losses"][0])
            / abs(want["losses"][0]),
            "bn_1": max(float((a[n] - b[n]).abs().max()) for n in names)
            / max(float(b[n].abs().max()) for n in names),
            "grad_cos_1": cos}


def d_check_train(label, ranks, one, steps):
    for r, res in enumerate(ranks):
        k = res["launches"]
        assert k["conv3d_packed_s1"] == 13 * steps and \
            k["fused_soft_argmin"] == 3 * steps and \
            k["fused_soft_argmin_backward"] == 3 * steps and \
            k["fused_conv3d"] == 0, (label, r, k)
        assert res["step_collectives"] == ranks[0]["step_collectives"]
        for n, p in ranks[0]["params"].items():
            assert torch.equal(p, res["params"][n]), (label, r, n)
    d_axis = ranks[0]["step_collectives"][2]
    assert d_axis == {"halo_exchange": 7, "halo_exchange_backward": 7,
                      "gather_d": 2, "gather_d_backward": 2}, d_axis
    assert len(ranks[0]["losses"]) == len(one["losses"]) == steps
    assert np.isfinite(ranks[0]["losses"]).all()
    err = d_first_step_errors(ranks[0], one)
    assert err["loss_1"] <= PAR_LOSS_RTOL and \
        err["bn_1"] <= PAR_STATE_TOL and \
        err["grad_cos_1"] > PAR_GRAD_COS, (label, err)
    return err


def d_shard_phase(smi):
    """Phase 21: the D-split eval on a (1, 2) grid in both dtypes and
    modes, training on (1, 2) and (2, 2) grids, each against one process;
    returns the launches of its runs (every rank's), float32's and
    bfloat16's."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    f32 = dict.fromkeys(SOURCES, 0)
    bf16 = dict.fromkeys(SOURCES, 0)
    with tempfile.TemporaryDirectory() as out:
        d_eval_rank(0, 1, None, out)
        torch.cuda.empty_cache()
        mp.start_processes(d_eval_rank, args=(2, free_port(), out),
                           nprocs=2, join=True, start_method="spawn")
        one = torch.load(os.path.join(out, "eval1_0.pt"), weights_only=False)
        two = [torch.load(os.path.join(out, f"eval2_{r}.pt"),
                          weights_only=False) for r in range(2)]
        for (dtype, fused), want in one.items():
            argmin = ("fused_upsample_soft_argmin" if fused
                      else "fused_soft_argmin")
            total = f32 if dtype == "f32" else bf16
            worst = []
            for r, res in enumerate(two):
                got = res[dtype, fused]
                k, kb = got["launches"], got["bf16_launches"]
                if dtype == "f32":
                    assert k["fused_conv3d"] == 13 and \
                        kb["conv3d_packed_s1"] == 0, (r, dtype, fused, k)
                else:
                    assert k["fused_conv3d"] == 0 and \
                        kb["conv3d_packed_s1"] == 13, (r, dtype, fused, kb)
                assert k[argmin] == 3, (r, dtype, fused, k)
                assert got["d_axis"] == {
                    "halo_exchange": 7, "halo_exchange_backward": 0,
                    "gather_d": 2, "gather_d_backward": 0}, got["d_axis"]
                assert all(torch.isfinite(d).all() for d in got["disps"])
                # float32: the largest gap; bfloat16: the mean gap
                gaps = [(g - w).abs() for g, w in zip(got["disps"],
                                                      want["disps"])]
                worst.append(max(float(e.max() if dtype == "f32"
                                       else e.mean()) for e in gaps))
                for name, n in k.items():
                    total[name] += n
            bound = D_F32_ATOL if dtype == "f32" else D_BF16_ATOL
            assert max(worst) <= bound, (dtype, fused, worst)
            g = two[0][dtype, fused]
            print(f"D-split eval {D_CONFIG}_{dtype} "
                  f"{'fused' if fused else 'plain'} 1x{D_FRAME[0]}x"
                  f"{D_FRAME[1]}, (1, 2) grid of gloo ranks on cuda:0 vs "
                  f"one process: {'max' if dtype == 'f32' else 'mean'} "
                  f"|d - d_one| per rank {[float(f'{x:.3g}') for x in worst]}"
                  f" px (bound {bound}); launches per rank {g['launches']} "
                  f"(bf16 {g['bf16_launches']}); a forward's collectives "
                  f"per rank {g['collectives']}, bytes {g['bytes']}, D-axis "
                  f"{g['d_axis']}; peak {g['peak_gib']:.2f} GiB a rank vs "
                  f"{want['peak_gib']:.2f} GiB one process; forward "
                  f"{g['ms']:.1f} ms a rank (gloo through the host) vs "
                  f"{want['ms']:.1f} ms, host clock: a check, not a speed; "
                  f"{smi}")
        torch.cuda.empty_cache()
        for grid, steps, batch in (((1, 2), D_STEPS, D_GLOBAL),
                                   ((2, 2), D_GRID_STEPS, D_GRID_GLOBAL)):
            world = grid[0] * grid[1]
            d_train_rank(0, 1, None, None, steps, batch, out)
            one = torch.load(os.path.join(out, "train1_0.pt"),
                             weights_only=False)
            torch.cuda.empty_cache()
            mp.start_processes(d_train_rank,
                               args=(world, free_port(), grid, steps, batch,
                                     out),
                               nprocs=world, join=True, start_method="spawn")
            ranks = [torch.load(os.path.join(out, f"train{world}_{r}.pt"),
                                weights_only=False) for r in range(world)]
            err = d_check_train(grid, ranks, one, steps)
            for res in (one, *ranks):
                for name, n in res["launches"].items():
                    f32[name] += n
            counts, nbytes, d_axis = ranks[0]["step_collectives"]
            print(f"D-split train_matcher {PAR_CONFIG}_f32 on a {grid} grid "
                  f"of gloo ranks on cuda:0, global batch {batch} at "
                  f"256x512, {steps} steps, vs one process: losses "
                  f"{[round(x, 4) for x in ranks[0]['losses']]} vs "
                  f"{[round(x, 4) for x in one['losses']]}; first step "
                  f"{ {k: float(f'{v:.4g}') for k, v in err.items()} }; the "
                  f"ranks' params bitwise equal; launches per rank "
                  f"{ranks[0]['launches']}; a step's collectives per rank "
                  f"{counts}, bytes {nbytes}, D-axis {d_axis}; peak "
                  f"{ranks[0]['peak_gib']:.2f} GiB a rank vs "
                  f"{one['peak_gib']:.2f} GiB one process; step "
                  f"{float(np.median(ranks[0]['step_ms'][1:])):.1f} ms a "
                  f"rank vs {float(np.median(one['step_ms'][1:])):.1f} ms "
                  f"(median of steps 2-{steps}, host clock: a check, not a "
                  f"speed); {smi}")
    print(f"D-split phase: {time.perf_counter() - t0:.1f} s; {smi}")
    return f32, bf16


# The two study tools (phase 22): eval_batch_study's default config and
# frame at a shorter run, dsharding_halo_study on a (1, 2) grid of gloo
# ranks on cuda:0 at its default shape
STUDY_EVAL = ["--n", "16", "--batches", "1", "4"]
STUDY_HALO = ["--n-model", "2"]


def study_phase(smi):
    """tools/eval_batch_study.py and tools/dsharding_halo_study.py through
    their main(argv): the EPE the same at batch 1 and 4, every time
    finite; the halo study's collectives those of phase 21's eval forward
    (7 halos, 2 gathers), its compute measured on the card."""
    from densematchingbenchmark_tpu_torch.tools import (dsharding_halo_study,
                                                        eval_batch_study)
    t0 = time.perf_counter()
    rec = eval_batch_study.main(STUDY_EVAL)
    assert abs(rec["batch4_epe"] - rec["batch1_epe"]) <= EVAL_EPE_ATOL, rec
    assert all(rec[f"batch{b}_ms_per_sample"] > 0 for b in (1, 4)), rec
    print(f"eval_batch_study {' '.join(STUDY_EVAL)} ({rec['config']}, "
          f"{rec['dtype']}, {rec['shape'][0]}x{rec['shape'][1]}): "
          f"{rec['batch1_ms_per_sample']:.2f} ms a sample at batch 1, "
          f"{rec['batch4_ms_per_sample']:.2f} at batch 4 (host clock, "
          f"end to end), speedup {rec['speedup']:.3f}, EPE "
          f"{rec['batch1_epe']:.5f} / {rec['batch4_epe']:.5f} px; {smi}")
    torch.cuda.empty_cache()
    halo = dsharding_halo_study.main(STUDY_HALO)
    assert halo["d_axis_counts"] == {
        "halo_exchange": 7, "halo_exchange_backward": 0, "gather_d": 2,
        "gather_d_backward": 0}, halo
    assert halo["single_chip_compute_ms"] > 0 and \
        halo["break_even_link_gbps"] > 0, halo
    print(f"dsharding_halo_study {' '.join(STUDY_HALO)} (a model at "
          f"{halo['link_gbps']} GB/s, not a measured multi-GPU speed): "
          f"{halo['collective_bytes']['all_gather']} bytes handed to "
          f"{halo['collective_counts']['all_gather']} all-gathers a rank, "
          f"{halo['gather_bytes_mib']:.1f} MiB received, "
          f"{halo['modeled_transfer_ms']:.3f} ms modelled; the one-process "
          f"aggregator forward {halo['single_chip_compute_ms']:.3f} ms "
          f"(CUDA events), {halo['compute_saved_ms']:.3f} ms saved; "
          f"break-even {halo['break_even_link_gbps']:.2f} GB/s; "
          f"{time.perf_counter() - t0:.1f} s; {smi}")
    torch.cuda.empty_cache()


# Correlation (phase 16): PSMNet/scene_flow with the Correlation cost
# processor at full width; the one-channel volume reaches the first trunk
# unit padded with zero channels (K1: Ci 4; K4's bfloat16 route: Ci 16)
CORR = {"model.cost_processor.type": "Correlation"}
CORR_CONFIG = "PSMNet/scene_flow"
CORR_CPU_ATOL = 1e-3   # px: the card against the plain versions on the CPU,
                       # same weights, a small pair (float32)
CORR_TRAIN_STEPS = 3
# (config, K1 launches a float32 forward, K2 launches) of the families
# whose aggregators JAX runs on a correlation volume beside PSMNet's
CORR_OTHERS = (("GCNet/scene_flow_f32", 10, 1),
               ("AcfNet/scene_flow_uniform_f32", 13, 3))


def corr_mode(name, fused, pairs, smi):
    """init_model(``name`` with a correlation volume, seed 0, BN drawn by
    damp_bn) in one eval mode and inference_stereo over ``pairs`` padded
    to PADDED: launches
    asserted (float32: K1 13 a forward; bfloat16: K4's bfloat16 route 13,
    K1 none; K2 or K3 3), the trunk's kept operands built in the first
    frame only (13, then none); the disparities finite, of the frame's
    shape; forward ms (CUDA events) and peak memory; the forward under the
    sync guard (the zero channels of the first unit's pad copy nothing
    from the host); in the plain mode, the first unit as the first frame
    ran it against its plain version (corr_first_unit). Returns (model,
    disparities, counts)."""
    from densematchingbenchmark_tpu_torch.apis import (inference_stereo,
                                                       init_model)
    from densematchingbenchmark_tpu_torch.models.layers import ConvUnit
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    model = init_model(name, seed=0, **CORR,
                       **{"model.eval.fused_upsample_argmin": fused})
    damp_bn(model.module, 0)
    agg = model.module.cost_processor.aggregator
    assert agg.ConvUnit_0.in_features == 1, agg.ConvUnit_0.widths
    bf16 = model.cfg["model"]["dtype"] == "bfloat16"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    builds = ConvUnit.operand_builds
    seen = []
    hook = agg.ConvUnit_0.register_forward_hook(
        lambda unit, args, out: seen.append((args[0], out)) if not seen
        else None)
    results = inference_stereo(model, pairs[:1], pad_to_shape=PADDED)
    hook.remove()
    first = ConvUnit.operand_builds - builds
    results += inference_stereo(model, pairs[1:], pad_to_shape=PADDED)
    later = ConvUnit.operand_builds - builds - first
    torch.cuda.synchronize()
    counts, bf16_counts = kernels.launch_counts(), kernels.bf16_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert (first, later) == (13, 0), (first, later)
    n = len(pairs)
    want = {k: 0 for k in counts}
    want["conv3d_packed_s1" if bf16 else "fused_conv3d"] = 13 * n
    want["fused_upsample_soft_argmin" if fused
         else "fused_soft_argmin"] = 3 * n
    assert counts == want, counts
    assert bf16_counts["conv3d_packed_s1"] == (13 * n if bf16 else 0), \
        bf16_counts
    disps = []
    for r in results:
        assert len(r["disps"]) == 3
        for d in r["disps"]:
            assert d.shape == (1, *IMAGE, 1) and np.isfinite(d).all()
        disps.append(r["disps"])
    if not fused:
        corr_first_unit(agg.ConvUnit_0, *seen[0])
    del seen
    x = torch.randn((1, *PADDED, 3), device="cuda")
    ms = time_ms(lambda: model.forward(x, x), FORWARD_REPS)
    print(f"correlation {name} fused_upsample_argmin={fused}: forward "
          f"{ms:.2f} ms (median of {FORWARD_REPS}, 1x{PADDED[0]}x"
          f"{PADDED[1]}), peak {peak:.2f} GiB, launches over {n} pairs "
          f"{counts} (bf16 route {bf16_counts}), kept operands built "
          f"{first} in the first frame, {later} after; {smi}")
    guarded(f"{name} + Correlation eval forward at {PADDED}, "
            f"fused_upsample_argmin={fused}", lambda: model.forward(x, x))
    return model, disps, counts


def corr_first_unit(unit, x, got):
    """The first trunk unit of the full-width correlation model as the
    main path ran it (``x`` its one-channel input, ``got`` its output in
    the first frame): K1 with Ci padded 1 -> 4 in float32, K4's bfloat16
    route with Ci padded 1 -> 16 in bfloat16, against the plain version of
    the unpadded unit on the same input and folded BN (CONV_RTOL of
    max|plain|, BF16_STEP besides in bfloat16)."""
    from densematchingbenchmark_tpu_torch.ops.cuda import (
        conv3d_packed_s1_plain, conv3d_plain)
    f32 = unit.dtype == torch.float32
    assert unit.padded and unit.widths.ci == (4 if f32 else 16), \
        unit.widths
    assert x.shape[-1] == 1 and got.shape[-1] == unit.features, \
        (x.shape, got.shape)
    with torch.no_grad():
        inv, shift = unit.folded_bn()
        kernel = unit.Conv_0.weight.permute(2, 3, 4, 1, 0).to(unit.dtype)
        x = x.to(unit.dtype)
        want = (conv3d_plain(x, kernel, inv, shift, unit.relu) if f32 else
                conv3d_packed_s1_plain(x, kernel, inv, shift, 1, unit.relu))
    top = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    tol = (CONV_RTOL if f32 else CONV_RTOL + BF16_STEP) * top
    print(f"correlation first unit {'K1' if f32 else 'K4 bf16'} 1->"
          f"{unit.features} (Ci padded to {unit.widths.ci}) "
          f"{'x'.join(map(str, x.shape[1:4]))}: max_abs_err {err:.3g} "
          f"against the plain version (tolerance {tol:.3g})")
    assert err <= tol, (unit.dtype, err, tol)


def corr_small_vs_cpu(shape=(64, 128)):
    """A small PSMNet with a correlation volume (SMALL, BN drawn by
    damp_bn) on the card against the same weights through the plain
    versions on the CPU, one random pair of ``shape``: float32 within
    CPU_ATOL max; bfloat16 by the CPU's own bfloat16-vs-float32 gap (about
    10 times the concatenation model's: the volume rounds 32-channel
    sums), each disparity's mean gap to the CPU within twice it plus 0.01
    px and the card's own gap at least half of it (as
    tests/test_torch_cuda.py::test_correlation_model_on_card_matches_cpu)."""
    from densematchingbenchmark_tpu_torch.apis import (StereoModel,
                                                       inference_stereo,
                                                       init_model)
    pair = random_pairs(np.random.RandomState(6), 1, shape)
    out = {}
    for suffix in ("_f32", "_bf16"):
        cpu = init_model(CORR_CONFIG + suffix, device="cpu", seed=4,
                         **SMALL, **CORR)
        damp_bn(cpu.module, 4)
        card = StereoModel(cpu.cfg, copy.deepcopy(cpu.module).cuda(),
                           torch.device("cuda"))
        out[suffix] = (inference_stereo(card, pair)[0]["disps"],
                       inference_stereo(cpu, pair)[0]["disps"])
    err = max(float(np.abs(g - w).max()) for g, w in zip(*out["_f32"]))
    assert err <= CPU_ATOL, err
    rows = []
    for (g, w), (g32, w32) in zip(zip(*out["_bf16"]), zip(*out["_f32"])):
        gap, own = float(np.abs(g - w).mean()), float(np.abs(w - w32).mean())
        card_own = float(np.abs(g - g32).mean())
        assert gap <= 2 * own + 0.01 and card_own >= 0.5 * own, \
            (gap, own, card_own)
        rows.append(f"{gap:.4f} (own {own:.4f}, card's own {card_own:.4f})")
    print(f"correlation small model ({SMALL['model.max_disp']} disps, "
          f"{shape}), card vs CPU plain versions: float32 {err:.4g} px max "
          f"(tolerance {CPU_ATOL}); bf16 mean " + ", ".join(rows) + " px")


def correlation_phase(smi):
    """Phase 16: the Correlation cost processor (the one-channel volume,
    ops.cost_volume.correlation1d_volume) on PSMNet at full width in both
    eval modes and both dtypes (corr_mode, with the first unit against its
    plain version, corr_first_unit; the cost sizes of the seeded, damped
    and concatenation models printed first), the bfloat16 disparities
    against the float32 model's of the same seed (BF16_GAP_ATOL), the card
    against the CPU on a small pair (float32, CORR_CPU_ATOL), a small
    model against the CPU in each dtype (corr_small_vs_cpu),
    CORR_TRAIN_STEPS steps of train_matcher at 3x256x512
    in float32 (K4 13 a step, K2 3 and its backward 3), and one float32
    forward of GCNet and AcfNet with a correlation volume (K1 launches
    asserted). Returns the launch counts of the float32 runs and of the
    bfloat16 runs."""
    from densematchingbenchmark_tpu_torch.apis import (StereoModel,
                                                       inference_stereo,
                                                       init_model)
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    t0 = time.perf_counter()
    # at seed 0 (identity BN) the correlation volume's 32-channel sums of
    # unnormalised features make costs far larger than the concatenation
    # model's, where the soft-argmin is a hard argmax and float32 rounding
    # moves a disparity by tenths of a pixel; with BN drawn as the CPU
    # tests draw it (damp_bn) they are of the concatenation model's size,
    # and the checks below run there
    x = torch.randn((1, *PADDED, 3), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    sizes = []
    for over, damp in ((CORR, False), (CORR, True), ({}, False)):
        model = init_model(CORR_CONFIG + "_f32", seed=0, **over)
        if damp:
            damp_bn(model.module, 0)
        sizes.append(max(float(c.abs().max())
                         for c in model.forward(x, x)["costs"]))
    print(f"correlation: largest |cost| of a forward at {PADDED}: seed 0 "
          f"{sizes[0]:.1f}, BN drawn by damp_bn {sizes[1]:.1f}; the "
          f"concatenation model at seed 0 {sizes[2]:.1f}")
    del model
    rng = np.random.RandomState(16)
    pairs = random_pairs(rng, PAIRS, IMAGE)
    totals = {}
    f32_disps = []
    for suffix in ("_f32", "_bf16"):
        total = totals.setdefault(suffix, {})
        for fused in (False, True):
            model, disps, counts = corr_mode(CORR_CONFIG + suffix, fused,
                                             pairs, smi)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            if suffix == "_f32":
                f32_disps.append(disps)
                if not fused:
                    f32_model = model
                continue
            # above 0 (the model computed in bfloat16) and within
            # BF16_GAP_ATOL: the correlation volume's bfloat16 rounding,
            # at the scale of its 32-channel sums, makes this model's own
            # gap about 10 times the concatenation model's (on the CPU,
            # at tests/test_torch_cuda.py's small size, 0.13-0.19 against
            # 0.008-0.017 px mean; on the card at full width, damped,
            # 2.17-2.25 px); its first unit is held against the plain
            # version in corr_mode and its bfloat16 path by the small
            # model against the CPU below
            ref = f32_disps[int(fused)]
            gap = max(float(np.abs(d - f).mean())
                      for ds, fs in zip(disps, ref) for d, f in zip(ds, fs))
            print(f"correlation bf16 fused_upsample_argmin={fused}: vs "
                  f"float32, same seed: mean |gap| up to {gap:.4f} px "
                  f"(tolerance {BF16_GAP_ATOL})")
            assert 0 < gap <= BF16_GAP_ATOL, gap
            del model
        torch.cuda.empty_cache()
    # MODES_ATOL is the concatenation model's, at its seeded costs; a
    # float32 rounding moves the soft-argmin in proportion to the costs'
    # size, so the bound scales with the damped model's largest |cost|
    # over the concatenation model's (both printed above)
    atol = MODES_ATOL * max(1.0, sizes[1] / sizes[2])
    modes = max(float(np.abs(a - b).max())
                for da, db in zip(*f32_disps) for a, b in zip(da, db))
    print(f"correlation: float32 eval modes agree to {modes:.3g} px "
          f"(tolerance {atol:.3g}: {MODES_ATOL} x {sizes[1]:.1f} / "
          f"{sizes[2]:.1f})")
    assert modes <= atol, modes
    cpu = StereoModel(f32_model.cfg, copy.deepcopy(f32_model.module).cpu(),
                      torch.device("cpu"))
    small = random_pairs(rng, 1, SMALL_IMAGE)
    pad = tuple(-(-s // 32) * 32 for s in SMALL_IMAGE)
    want = inference_stereo(cpu, small, pad_to_shape=pad)[0]["disps"]
    got = inference_stereo(f32_model, small, pad_to_shape=pad)[0]["disps"]
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    print(f"correlation: card vs CPU plain versions at {SMALL_IMAGE}, "
          f"float32: {err:.3g} px (tolerance {CORR_CPU_ATOL})")
    assert err <= CORR_CPU_ATOL, err
    del f32_model, cpu
    corr_small_vs_cpu()
    torch.cuda.empty_cache()
    counts = family_train_phase(
        smi, CORR_CONFIG + "_f32", CORR_TRAIN_STEPS,
        keys=[f"l1_loss_lvl{i}" for i in range(3)], overrides=CORR)
    for k, v in counts.items():
        totals["_f32"][k] += v
    torch.cuda.empty_cache()
    x = torch.randn((1, *PADDED, 3), device="cuda")
    for name, k1, k2 in CORR_OTHERS:
        model = init_model(name, seed=0, **CORR)
        assert model.module.cost_processor.aggregator.ConvUnit_0 \
            .in_features == 1
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        out = model.forward(x, x)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = {k: 0 for k in counts}
        want["fused_conv3d"], want["fused_soft_argmin"] = k1, k2
        assert counts == want, (name, counts)
        for d in out["disps"]:
            assert d.shape == (1, *PADDED, 1) and bool(torch.isfinite(d).all())
        for k, v in counts.items():
            totals["_f32"][k] += v
        ms = time_ms(lambda: model.forward(x, x), 3)
        print(f"correlation {name}: forward {ms:.2f} ms (median of 3, "
              f"1x{PADDED[0]}x{PADDED[1]}), peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
              f"launches {counts}; {smi}")
        del model, out
        torch.cuda.empty_cache()
    print(f"correlation phase: {time.perf_counter() - t0:.1f} s")
    return totals["_f32"], totals["_bf16"]


def tools_phase(smi):
    """Phase 17: the port's measurement tools through their main(argv) on
    the card: tools/benchmark.py over every family in each dtype (--iters
    3), tools/train_throughput.py over every family (--iters 2),
    tools/profile_model.py on PSMNet's forward and on its train step, and
    tools/loader_throughput.py on a small SceneFlow-shaped set against
    the PSMNet train step just measured. Every row: finite, positive
    times; the zoo's parameter count the built module's; GFLOPs. Prints
    the tables and the phase's seconds."""
    from densematchingbenchmark_tpu_torch.configs import get_config
    from densematchingbenchmark_tpu_torch.models import build_model
    from densematchingbenchmark_tpu_torch.tools import (benchmark,
                                                        loader_throughput,
                                                        profile_model,
                                                        train_throughput)
    t0 = time.perf_counter()

    def positive(x):
        return isinstance(x, float) and np.isfinite(x) and x > 0
    for dtype in ("float32", "bfloat16"):
        rows = benchmark.main(["--dtype", dtype, "--iters", "3"])
        assert [r["model"] for r in rows] == list(benchmark.BASELINES_FPS)
        for r in rows:
            assert "error" not in r, r
            module = build_model(get_config(r["model"]))
            assert r["params"] == sum(p.numel() for p in
                                      module.parameters()), r
            assert r["gflops"] > 0 and positive(r["latency_ms"]), r
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        records = os.path.join(work, "train.json")
        recs = train_throughput.main(["--iters", "2", "--out", records])
        assert [r["family"] for r in recs] == list(train_throughput.FAMILIES)
        for r in recs:
            assert positive(r["f32_ms"]) and positive(r["bf16_ms"]), r
        torch.cuda.empty_cache()
        for extra in ([], ["--train", "--height", "256", "--width", "512"]):
            trace = os.path.join(work, "trace.json")
            summary = profile_model.main(
                ["--config", "PSMNet/scene_flow", "--iters", "2",
                 "--height", "384", "--width", "1248", "--out", trace]
                + extra)
            assert os.path.getsize(trace) > 0 and summary["kernels"]
            assert summary["launches"] > 0 and positive(summary["busy_ms"])
            torch.cuda.empty_cache()
        rec = loader_throughput.main(["--n", "6", "--epochs", "1",
                                      "--throughput-json", records])
        assert positive(rec["value"]) and rec["vs_train_step_demand"] > 0
    print(f"tools phase: {time.perf_counter() - t0:.1f} s; {smi}")


# The convergence gauntlet's overfit mode on the card (phase 18): every
# family of tools/convergence_gauntlet.py's tables through its
# run_stereo_family / run_flow_family at full width, its config name (so
# bfloat16 on the card), crop 128x256, batch 2 (GCNet 1), with the CPU
# test's speed overrides (lr 2e-3, no warmup).
GAUNTLET_STEPS = 24
GAUNTLET_CROP = (128, 256)
# (K4 launches, K2 launches) of one train step and of one eval forward of
# each stereo family in bfloat16: the bfloat16 route of K4 (GCNet's and
# DeepPruner's units wider than 112 input channels in two Ci slices, one
# launch each), K2 as family_train_phase asserts it; the flow families none
GAUNTLET_LAUNCHES = {"PSMNet": (13, 3), "AcfNet-adaptive": (13, 3),
                     "AcfNet-uniform": (13, 3), "GCNet": (GC_BF16_UNITS, 1),
                     "StereoNet-2stage": (STEREO_UNITS, 1),
                     "StereoNet-4stage": (STEREO_UNITS, 1),
                     "AnyNet": (AN_UNITS, AN_ARGMINS),
                     "DeepPruner-4x": (DP_BF16_UNITS, 0),
                     "DeepPruner-8x": (DP_BF16_UNITS, 0)}
GAUNTLET_DROP = 0.7    # loss_last < 0.7 loss_first: JAX's CPU criterion
# AcfNet-adaptive's ratio and its batch EPE after 24 steps are not stable
# quantities: on the card 0.64-0.92 in bfloat16 over seeds and repeated
# runs (which differ: cuDNN's and the kernels' float sums are not
# ordered), 0.93 in float32, its EPE up in one run of eight; on the CPU
# JAX's own run ends at 0.681 and at 0.83 with its weights perturbed by
# 1e-7 (ROADMAP section 3). Its loss falls in every run: that is asserted.
GAUNTLET_DESCENT_ONLY = ("AcfNet-adaptive",)
# Runs of one family on the card differ (float sums on the card are not
# ordered; with cudnn.deterministic set too). AcfNet-uniform's ratio after
# 24 steps spreads across 0.42-0.78 in bfloat16 over runs of seed 0, and
# about one run in eight misses JAX's criterion, by its ratio or by its
# batch EPE rising (tests/gauntlet_spread_study.py). A family whose first
# run misses is therefore run GAUNTLET_RUNS - 1 more times with the same
# seed, and must meet the criterion in a majority of all its runs.
GAUNTLET_RUNS = 5


def gauntlet_phase(smi):
    """Phase 18: tools/convergence_gauntlet.py's overfit mode on every one
    of its 11 families at full width (GAUNTLET_STEPS steps on the first
    batch, which is scored before and after): the loss must fall below
    GAUNTLET_DROP of its first value and the batch's EPE must fall (JAX's
    tests/test_convergence_gauntlet.py criterion); the launches of the
    whole run asserted (each step and each of the two eval forwards K4's
    bfloat16 route and K2 by GAUNTLET_LAUNCHES, K2's backward each step,
    K1, K3 and K5 none; the flow families none of K1-K5); each family's
    seconds. AcfNet-adaptive is held to its loss falling
    (GAUNTLET_DESCENT_ONLY). A family whose first run misses is run
    GAUNTLET_RUNS - 1 more times and must meet the criterion in a
    majority of its GAUNTLET_RUNS runs. Returns the launch counts of every
    run (all bfloat16)."""
    from densematchingbenchmark_tpu_torch.configs import get_config
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    from densematchingbenchmark_tpu_torch.tools import (
        convergence_gauntlet as gauntlet)
    t_phase = time.perf_counter()
    n = GAUNTLET_STEPS
    total = {k.__name__: 0 for k in kernels.KERNELS}
    missed = []
    for task, families in (("stereo", gauntlet.STEREO_FAMILIES),
                           ("flow", gauntlet.FLOW_FAMILIES)):
        run = (gauntlet.run_stereo_family if task == "stereo"
               else gauntlet.run_flow_family)
        for family, config, overrides, threshold in families:
            def drive(attempt):
                """One run of the family; asserts its launches, adds them
                to the phase's total and returns (criterion met, record)."""
                cfg = get_config(config, **overrides)
                assert cfg["model"].get("dtype", "float32") == "bfloat16", \
                    cfg
                cfg["name"] = config
                cfg["optimizer"]["lr"] = 2e-3
                cfg.setdefault("lr_schedule", {})["warmup_iters"] = 0
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                r = run(cfg, steps=n, batch=1 if family == "GCNet" else 2,
                        crop_hw=GAUNTLET_CROP, log_every=4, overfit=True,
                        device="cuda")
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                counts = kernels.launch_counts()
                bf16 = kernels.bf16_launch_counts()
                units, argmins = GAUNTLET_LAUNCHES.get(family, (0, 0))
                assert counts == {"fused_conv3d": 0,
                                  "fused_soft_argmin": (n + 2) * argmins,
                                  "fused_soft_argmin_backward": n * argmins,
                                  "fused_upsample_soft_argmin": 0,
                                  "conv3d_packed_s1": (n + 2) * units,
                                  "conv3d_packed_s1_v2": 0}, (family, counts)
                assert bf16["conv3d_packed_s1"] == (n + 2) * units, \
                    (family, bf16)
                ratio = r["loss_last"] / r["loss_first"]
                met = (r["loss_last"] < r["loss_first"]
                       if family in GAUNTLET_DESCENT_ONLY else
                       ratio < GAUNTLET_DROP
                       and r["epe_final"] < r["epe_init"])
                met = bool(met and np.isfinite(
                    [v for _, v in r["losses"]]).all())
                print(f"gauntlet {family} ({config}, bfloat16, overfit, "
                      f"{r['batch']}x{r['crop'][0]}x{r['crop'][1]}, {n} "
                      f"steps, run {attempt}): loss {r['loss_first']} -> "
                      f"{r['loss_last']} (ratio {ratio:.4f}; "
                      f"{r['losses']}), EPE {r['epe_init']} -> "
                      f"{r['epe_final']} (300-step threshold {threshold}); "
                      f"criterion {'met' if met else 'missed'}; {secs:.1f} s "
                      f"({r['train_s']} s training); launches {counts}; "
                      f"{smi}")
                for k, v in counts.items():
                    total[k] += v
                torch.cuda.empty_cache()
                return met, r

            runs = [drive(1)]
            if not runs[0][0]:
                runs += [drive(k) for k in range(2, GAUNTLET_RUNS + 1)]
            if 2 * sum(met for met, _ in runs) <= len(runs):
                missed.append((family, [r for _, r in runs]))
    print(f"gauntlet phase: {time.perf_counter() - t_phase:.1f} s; {smi}")
    # every family is run and printed before the criterion is asserted
    assert not missed, missed
    return total


def unit_hooks(module, names):
    """Forward hooks keeping each named unit's (input, output) of the next
    call; returns (the dict they fill, their handles)."""
    seen = {}
    handles = [getattr(module, name).register_forward_hook(
        lambda m, args, out, name=name: seen.__setitem__(
            name, (args[0].detach(), out.detach()))) for name in names]
    return seen, handles


def check_hourglass_unit(label, unit, x, got, train):
    """One stride-1 unit of DilatedHourglass3D as the module ran it against
    its plain version on the same input: in eval the folded-BN epilogue
    (K1 float32 / K4's bfloat16 route against conv3d_plain /
    conv3d_packed_s1_plain), in training K4 at unit scale then the batch's
    BN (and ReLU) against the plain conv then the same BN. CONV_RTOL of
    max|plain|, BF16_STEP besides in bfloat16. Returns the error."""
    from densematchingbenchmark_tpu_torch.ops.cuda import (
        conv3d_packed_s1_plain, conv3d_plain)
    f32 = unit.dtype == torch.float32
    assert not unit.padded and unit.fusable, unit
    with torch.no_grad():
        x = x.to(unit.dtype)
        kernel = unit.Conv_0.weight.permute(2, 3, 4, 1, 0).to(unit.dtype)
        if train:
            bn = unit.BatchNorm_0
            want = conv3d_packed_s1_plain(x, kernel, pack=1).float()
            want = F.batch_norm(want.movedim(-1, 1), None, None, bn.weight,
                                bn.bias, True, 0.0, bn.eps).movedim(1, -1)
            want = want.clamp_min(0.0) if unit.relu else want
        else:
            inv, shift = unit.folded_bn()
            want = (conv3d_plain(x, kernel, inv, shift, unit.relu) if f32
                    else conv3d_packed_s1_plain(x, kernel, inv, shift, 1,
                                                unit.relu))
    top = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    tol = (CONV_RTOL if f32 else CONV_RTOL + BF16_STEP) * top
    print(f"DilatedHourglass3D {label} {unit.in_features}->{unit.features} "
          f"{'x'.join(map(str, x.shape[1:4]))}: max_abs_err {err:.3g} "
          f"against the plain version (tolerance {tol:.3g})")
    assert err <= tol, (label, err, tol)
    return err


# PSMNet's hourglass input at 384x1248: 32 channels over 48x96x312
HOURGLASS_SHAPE = (1, 48, 96, 312, 32)
HOURGLASS_UNITS = ("ConvUnit_1", "ConvUnit_3")
AUX_RTOL = 1e-4     # of max|CPU|: a module's library convs, card vs CPU
AUX_ATOL = 1e-5     # the functions, card vs CPU (rtol the same)


def hourglass_phase(smi):
    """Phase 19a: DilatedHourglass3D(32) (models/layers_extra.py) at
    PSMNet's hourglass shape, its BN drawn by damp_bn: float32 eval (its
    two stride-1 units on K1: 2 launches), bfloat16 eval (K4's bfloat16
    route: 2) and one float32 training step (K4: 2; the loss's gradient
    finite), each unit held against its plain version
    (check_hourglass_unit); the forwards' ms. Returns the launch counts
    (float32, bfloat16)."""
    from densematchingbenchmark_tpu_torch.models.layers import (
        init_parameters)
    from densematchingbenchmark_tpu_torch.models.layers_extra import (
        DilatedHourglass3D)
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    f32_total = {k.__name__: 0 for k in kernels.KERNELS}
    bf16_total = dict(f32_total)
    gen = torch.Generator(device="cuda").manual_seed(19)
    x = torch.randn(HOURGLASS_SHAPE, device="cuda", generator=gen)
    for dtype, train in ((torch.float32, False), (torch.bfloat16, False),
                         (torch.float32, True)):
        module = DilatedHourglass3D(32, dtype=dtype)
        init_parameters(module, torch.Generator().manual_seed(19))
        module = damp_bn(module, 19).cuda().train(train)
        seen, handles = unit_hooks(module, HOURGLASS_UNITS)
        kernels.reset_launch_counts()
        with torch.set_grad_enabled(train):
            out = module(x)
            if train:
                loss = sum(o.float().square().mean() for o in out)
                grads = torch.autograd.grad(loss, list(module.parameters()))
                assert all(torch.isfinite(g).all() for g in grads)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        for h in handles:
            h.remove()
        label = ("train" if train else "eval") + (
            " bf16" if dtype == torch.bfloat16 else " f32")
        name = "conv3d_packed_s1" if (train or dtype == torch.bfloat16) \
            else "fused_conv3d"
        assert counts == {**{k: 0 for k in counts}, name: 2}, (label,
                                                               counts)
        assert kernels.bf16_launch_counts()["conv3d_packed_s1"] == (
            2 if dtype == torch.bfloat16 else 0)
        assert out[0].shape == HOURGLASS_SHAPE and all(
            torch.isfinite(o).all() for o in out), label
        for unit_name in HOURGLASS_UNITS:
            check_hourglass_unit(f"{label} {unit_name}",
                                 getattr(module, unit_name),
                                 *seen[unit_name], train)
        if not train:
            with torch.no_grad():
                ms = time_ms(lambda: module(x))
            print(f"DilatedHourglass3D {label} forward "
                  f"{'x'.join(map(str, HOURGLASS_SHAPE))}: {ms:.3f} ms; "
                  f"{smi}")
        for k, v in counts.items():
            (bf16_total if dtype == torch.bfloat16 else f32_total)[k] += v
        del module, out, seen
        torch.cuda.empty_cache()
    return f32_total, bf16_total


def aux_pieces(rng):
    """(label, function, numpy args, kwargs) of every new library piece
    at a small shape: the modules (layers_extra's, WarpErrorRefinement,
    CostVolumeNorm, their BN drawn by damp_bn, called in eval and in
    training mode) and the functions (conf_measure, propagation,
    relative_loss, self_supervised, cost_norm's)."""
    from densematchingbenchmark_tpu_torch.losses import (relative_loss,
                                                         self_supervised)
    from densematchingbenchmark_tpu_torch.models import (conf_measure,
                                                         cost_norm,
                                                         layers_extra)
    from densematchingbenchmark_tpu_torch.models.layers import (
        init_parameters)
    from densematchingbenchmark_tpu_torch.models.refinement.warp_error \
        import WarpErrorRefinement
    from densematchingbenchmark_tpu_torch.ops import propagation

    def rand(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    def module(m, seed):
        init_parameters(m, torch.Generator().manual_seed(seed))
        return damp_bn(m, seed)
    cost = rand(2, 16, 12, 20, scale=3.0)
    gt = (rng.rand(2, 16, 32, 1) * 40 + 1).astype(np.float32)
    left = rng.rand(2, 16, 32, 3).astype(np.float32)
    disp = (rng.rand(2, 16, 32, 1) * 6).astype(np.float32)
    return [
        ("Hourglass2D", module(layers_extra.Hourglass2D(8), 1),
         (rand(2, 16, 24, 8),), {}),
        ("DilatedHourglass3D", module(layers_extra.DilatedHourglass3D(8), 2),
         (rand(2, 8, 16, 24, 8),), {}),
        ("DenseAspp", module(layers_extra.DenseAspp(16, 8), 3),
         (rand(2, 16, 24, 16),), {}),
        ("WarpErrorRefinement", module(WarpErrorRefinement(8, C=4), 4),
         (disp[:, ::2, ::2], rand(2, 16, 32, 8), rand(2, 16, 32, 8)), {}),
        ("CostVolumeNorm", cost_norm.CostVolumeNorm("std"), (cost,), {}),
        ("pkr_confidence", conf_measure.pkr_confidence, (cost,), {}),
        ("apkr_confidence", conf_measure.apkr_confidence, (cost,), {}),
        ("nlm_confidence", conf_measure.nlm_confidence, (cost,), {}),
        ("generate_gt_confidence", conf_measure.generate_gt_confidence,
         (gt + rand(2, 16, 32, 1), gt), {"lb": 0, "ub": 30.0}),
        ("affinity_propagate_2d", propagation.affinity_propagate_2d,
         (rand(2, 16, 32, 9), rand(2, 16, 32, 3)), {"iterations": 3}),
        ("affinity_propagate_3d", propagation.affinity_propagate_3d,
         (rand(1, 6, 12, 20, 27), rand(1, 6, 12, 20, 2)), {"dilation": 2}),
        ("bilateral_filter", propagation.bilateral_filter,
         (disp, left * 255), {}),
        ("relative_loss", relative_loss.relative_loss,
         ([gt + np.clip(rand(2, 16, 32, 1, scale=40.0), -85, 85)], gt,
          rng.randint(-1, 2, gt.shape).astype(np.float32)),
         {"max_disp": 192}),
        ("ssim", self_supervised.ssim, (left, rng.rand(*left.shape).astype(
            np.float32)), {}),
        ("lr_consistency_mask", self_supervised.lr_consistency_mask,
         (disp, disp + rand(2, 16, 32, 1, scale=0.8)), {}),
        ("inverse_warp_loss", self_supervised.inverse_warp_loss,
         ([disp, disp[:, ::2, ::2] / 2], left, np.roll(left, -4, axis=2)),
         {}),
        ("range_norm", cost_norm.range_norm, (cost,), {}),
        ("var_norm", cost_norm.var_norm, (cost,), {}),
    ]


def to_device(value, device):
    if isinstance(value, list):
        return [to_device(v, device) for v in value]
    return torch.from_numpy(value).to(device)


def flat_outputs(out):
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in flat_outputs(o)]
    return [out]


def aux_phase(smi):
    """Phase 19b: every other new library piece on the card against the
    CPU on the same inputs and weights (aux_pieces): a module's outputs,
    in eval and in training mode, within AUX_RTOL of max|CPU| (cuDNN
    against the CPU's convolutions, TF32 off), a function's within
    AUX_ATOL absolute and relative. Returns the launch counts (float32:
    the small DilatedHourglass3D's units on K1 in eval and K4 in
    training)."""
    from densematchingbenchmark_tpu_torch.ops import cuda as kernels
    kernels.reset_launch_counts()
    rows = []
    for label, fn, args, kwargs in aux_pieces(np.random.RandomState(19)):
        modes = (False, True) if isinstance(fn, torch.nn.Module) else (None,)
        for train in modes:
            outs = []
            for device in ("cpu", "cuda"):
                if train is not None:
                    fn = fn.to(device).train(train)
                with torch.no_grad():
                    outs.append([o.float().cpu() for o in flat_outputs(
                        fn(*to_device(list(args), device), **kwargs))])
            cpu, card = outs
            err, top = 0.0, 0.0
            for c, g in zip(cpu, card):
                assert c.shape == g.shape and torch.isfinite(g).all(), label
                err = max(err, (g - c).abs().max().item())
                top = max(top, c.abs().max().item())
            tol = (AUX_RTOL * max(top, 1.0) if train is not None
                   else AUX_ATOL * (1.0 + top))
            assert err <= tol, (label, train, err, tol)
            mode = {None: "", False: " eval", True: " train"}[train]
            rows.append(f"{label}{mode} {err:.2g}")
    counts = kernels.launch_counts()
    assert counts["fused_conv3d"] == 2 and counts["conv3d_packed_s1"] == 2, \
        counts
    print("new library pieces, card vs CPU (max abs err): "
          + ", ".join(rows) + f"; launches {counts}; {smi}")
    return counts


VIEW_COST_CONFIG = "PSMNet/scene_flow"
VIEW_COST_PROB_ATOL = 1e-3   # a probability, card vs CPU, float32
BF16_CONV_STEPS = 40
BF16_CONV_SHAPE = (128, 256)


def view_cost_phase(smi):
    """Phase 20a: tools/view_cost.py on PSMNet/scene_flow at full width on
    the card (bfloat16, its config name; random weights of seed 0): four
    PNGs that data/io.decode_png reads back at PLOT_SIZE, the curves
    finite and summing to 1; then in float32 (the _f32 name) on the card
    and, through cost_curves, the same weights on the CPU (the plain
    versions): each probability within VIEW_COST_PROB_ATOL and each
    estimate within CPU_ATOL px of the CPU's, the GT and pixels equal."""
    from densematchingbenchmark_tpu_torch.apis import init_model
    from densematchingbenchmark_tpu_torch.data import io as dio
    from densematchingbenchmark_tpu_torch.tools import view_cost
    t0 = time.perf_counter()
    results = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for suffix in ("", "_f32"):
            sub = os.path.join(out_dir, suffix or "default")
            results[suffix] = view_cost.main(
                ["--config", VIEW_COST_CONFIG + suffix, "--out-dir", sub])
            names = sorted(os.listdir(sub))
            assert names == sorted(f"cost_y{c['y']}_x{c['x']}.png"
                                   for c in results[suffix]["curves"]), names
            for name in names:
                with open(os.path.join(sub, name), "rb") as fp:
                    img = dio.decode_png(fp.read())
                assert img.shape == view_cost.PLOT_SIZE + (3,), img.shape
            for c in results[suffix]["curves"]:
                assert np.isfinite(c["prob"]).all()
                assert abs(float(c["prob"].sum()) - 1.0) < 1e-4, c
    cpu = view_cost.cost_curves(init_model(VIEW_COST_CONFIG + "_f32",
                                           device="cpu"))
    errs = []
    for got, want in zip(results["_f32"]["curves"], cpu["curves"]):
        assert (got["y"], got["x"], got["gt"]) == (want["y"], want["x"],
                                                   want["gt"])
        perr = float(np.abs(got["prob"] - want["prob"]).max())
        eerr = abs(got["est"] - want["est"])
        assert perr <= VIEW_COST_PROB_ATOL and eerr <= CPU_ATOL, \
            (perr, eerr)
        errs.append((perr, eerr))
    print(f"view_cost {VIEW_COST_CONFIG}: pixels "
          f"{[(c['y'], c['x']) for c in cpu['curves']]}, bf16 est "
          f"{[round(c['est'], 2) for c in results['']['curves']]}, gt "
          f"{[c['gt'] for c in cpu['curves']]}; float32 card vs CPU "
          f"(prob, est px) {[(f'{p:.2g}', f'{e:.2g}') for p, e in errs]}; "
          f"{time.perf_counter() - t0:.1f} s; {smi}")


def bf16_convergence_phase(smi):
    """Phase 20b: tools/bf16_convergence.py on PSMNet/scene_flow at full
    width, BF16_CONV_STEPS steps at BF16_CONV_SHAPE batch 2: both curves
    finite, each falling (the median of its second half below its first
    loss: a batch of the stream can lift one logged loss above the first,
    as float32's last did at 155 of 121 in one run), the record's keys;
    the step ms of each dtype and the speed-up printed (a short run's, not
    the tool's defaults)."""
    from densematchingbenchmark_tpu_torch.tools import bf16_convergence
    t0 = time.perf_counter()
    out = bf16_convergence.main(
        ["--steps", str(BF16_CONV_STEPS), "--height",
         str(BF16_CONV_SHAPE[0]), "--width", str(BF16_CONV_SHAPE[1]),
         "--log-every", "5"])
    assert sorted(out) == sorted(["config", "steps", "shape", "batch",
                                  "float32", "bfloat16", "tail_rel_diff",
                                  "speedup"]), out
    for dtype in ("float32", "bfloat16"):
        curve = [v for _, v in out[dtype]["curve"]]
        assert np.isfinite(curve).all(), (dtype, curve)
        assert np.median(curve[len(curve) // 2:]) < curve[0], (dtype, curve)
    print(f"bf16_convergence {out['config']} {BF16_CONV_STEPS} steps at "
          f"{out['batch']}x{BF16_CONV_SHAPE[0]}x{BF16_CONV_SHAPE[1]}: "
          f"float32 {out['float32']['curve']} ({out['float32']['step_ms']}"
          f" ms a step), bfloat16 {out['bfloat16']['curve']} "
          f"({out['bfloat16']['step_ms']} ms), tail_rel_diff "
          f"{out['tail_rel_diff']}, speedup {out['speedup']}; "
          f"{time.perf_counter() - t0:.1f} s; {smi}")


def main():
    t_start = time.perf_counter()
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
    bf16_trunk = check_bf16_trunk(gen, smi)
    # K1 and K4's bfloat16 route with AcfNet's conv bias in the shift
    bias_errs = check_bias_epilogue(gen)
    stats["fused_conv3d"]["bias_epilogue_max_abs_err"] = \
        bias_errs[torch.float32]
    bf16_trunk["bias_epilogue_max_abs_err"] = bias_errs[torch.bfloat16]
    # K2's backward on the bfloat16 training cost, beside its float32 row
    stats["fused_soft_argmin_backward"].update(check_bf16_regression(gen))
    torch.cuda.empty_cache()
    print("sync guard (torch.cuda.set_sync_debug_mode('error')):")
    sync_guard_phase(gen)
    torch.cuda.empty_cache()
    micro, micro_bf16, bf16_times = microbench_phase()
    torch.cuda.empty_cache()
    launches, models, pairs, f32_disps = slice_phase()
    for name, n in micro.items():
        launches[name] += n
    if "--profile" in sys.argv[1:]:
        profile_phase(models)
    del models
    torch.cuda.empty_cache()
    # the bfloat16 paths' launches, kept apart: K4's are its bfloat16 row's
    bf16_launches = bf16_slice_phase(pairs, f32_disps, smi)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        ann, items = write_kitti_dataset(root)
        counts, f32_eval = eval_phase(smi, gen, root, ann, items)
        for name, n in counts.items():
            launches[name] += n
        for name, n in bf16_eval_phase(smi, root, ann, f32_eval).items():
            bf16_launches[name] += n
    png_decode_phase(smi)
    torch.cuda.empty_cache()
    bench_phase(smi)
    torch.cuda.empty_cache()
    for name, n in train_phase(smi).items():
        launches[name] += n
    torch.cuda.empty_cache()
    for name, n in train_phase(smi, "PSMNet/scene_flow_bf16").items():
        bf16_launches[name] += n
    torch.cuda.empty_cache()
    same_weights_phase()
    overfit_phase()
    bf16_small_phase(smi)
    torch.cuda.empty_cache()

    # AcfNet: inference, evaluation with sparsification, training, in
    # float32 and bfloat16; its launches join each dtype's counts
    acf_f32, acf_bf16 = acf_slice_phase(smi)
    if "--profile" in sys.argv[1:]:
        acf_profile_phase()
    torch.cuda.empty_cache()
    acf_runs = [(acf_f32, launches), (acf_bf16, bf16_launches)]
    with tempfile.TemporaryDirectory() as root:
        ann, _ = write_kitti_dataset(root)
        f32_eval, bf16_eval = acf_eval_phase(smi, root, ann)
        acf_runs += [(f32_eval, launches), (bf16_eval, bf16_launches)]
    torch.cuda.empty_cache()
    for name, steps, total in ((ACF_CONFIG + "_f32", TRAIN_STEPS, launches),
                               (ACF_CONFIG + "_bf16", TRAIN_STEPS,
                                bf16_launches),
                               ("AcfNet/scene_flow_uniform_f32", 1,
                                launches)):
        acf_runs.append((family_train_phase(smi, name, steps), total))
        torch.cuda.empty_cache()
    acf_runs.append((acf_profile_cli_phase(), launches))
    for counts, total in acf_runs:
        for name, n in counts.items():
            total[name] += n
    torch.cuda.empty_cache()

    # StereoNet: its kernels at its shapes, inference, evaluation over a
    # SceneFlow-layout set, training, in float32 and bfloat16; fault 8's
    # width dispatch on the card; its launches join each dtype's counts
    for row, extra in check_stereonet_kernels(gen).items():
        (bf16_trunk if row == "conv3d_packed_s1_bf16_pack1"
         else stats[row]).update(extra)
    fault8_phase(smi)
    torch.cuda.empty_cache()
    stereo_f32, stereo_bf16 = stereonet_slice_phase(smi)
    stereo_runs = [(stereo_f32, launches), (stereo_bf16, bf16_launches)]
    if "--profile" in sys.argv[1:]:
        stereonet_profile_phase()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        ann, items = write_sceneflow_dataset(root)
        f32_eval, bf16_eval = stereonet_eval_phase(smi, root, ann, items)
        stereo_runs += [(f32_eval, launches), (bf16_eval, bf16_launches)]
    torch.cuda.empty_cache()
    for suffix, total in (("_f32", launches), ("_bf16", bf16_launches)):
        stereo_runs.append((family_train_phase(
            smi, STEREO_CONFIG + suffix, TRAIN_STEPS, units=STEREO_UNITS,
            argmins=1, keys=[f"l1_loss_lvl{i}" for i in range(4)]), total))
        torch.cuda.empty_cache()
    for counts, total in stereo_runs:
        for name, n in counts.items():
            total[name] += n
    torch.cuda.empty_cache()

    # GCNet and DeepPruner: fault 9, their units on the kernels, inference,
    # evaluation, training, in float32 and bfloat16
    gcnet_phase(smi, gen, stats, bf16_trunk, launches, bf16_launches)
    torch.cuda.empty_cache()
    deeppruner_phase(smi, gen, stats, bf16_trunk, launches, bf16_launches)
    torch.cuda.empty_cache()
    # AnyNet: its pre-norm units on the kernels, inference, evaluation,
    # training, in float32 and bfloat16
    anynet_phase(smi, gen, stats, bf16_trunk, launches, bf16_launches)
    torch.cuda.empty_cache()
    # optical flow: PWCFlow and RAFT, inference, evaluation, training and
    # the demo in float32 and bfloat16; they launch none of the kernels
    flow_phase(smi)
    torch.cuda.empty_cache()
    # data parallelism: the gloo pair against one rank in each dtype, the
    # NCCL rank; each rank's launches join its dtype's counts
    par_f32, par_bf16 = parallel_phase(smi)
    for name, n in par_f32.items():
        launches[name] += n
    for name, n in par_bf16.items():
        bf16_launches[name] += n
    torch.cuda.empty_cache()
    # the Correlation cost processor: PSMNet in both modes and dtypes,
    # card vs CPU, training, GCNet and AcfNet; its launches join each
    # dtype's counts
    corr_f32, corr_bf16 = correlation_phase(smi)
    for name, n in corr_f32.items():
        launches[name] += n
    for name, n in corr_bf16.items():
        bf16_launches[name] += n
    torch.cuda.empty_cache()
    # the measurement tools on the card (their launches are not a path's)
    tools_phase(smi)
    torch.cuda.empty_cache()
    # the convergence gauntlet's overfit mode on every family (bfloat16)
    for name, n in gauntlet_phase(smi).items():
        bf16_launches[name] += n
    # the library pieces no shipped config reaches: DilatedHourglass3D at
    # PSMNet's hourglass shape in each dtype and training, the others card
    # vs CPU
    hg_f32, hg_bf16 = hourglass_phase(smi)
    for total, counts in ((launches, hg_f32), (bf16_launches, hg_bf16),
                          (launches, aux_phase(smi))):
        for name, n in counts.items():
            total[name] += n
    torch.cuda.empty_cache()
    # view_cost's curves and PNGs, and a short bf16_convergence run
    view_cost_phase(smi)
    torch.cuda.empty_cache()
    bf16_convergence_phase(smi)
    torch.cuda.empty_cache()
    # the D-sharded cost volume on grids of gloo ranks on the card
    d_f32, d_bf16 = d_shard_phase(smi)
    for total, counts in ((launches, d_f32), (bf16_launches, d_bf16)):
        for name, n in counts.items():
            total[name] += n
    torch.cuda.empty_cache()
    # the study tools (their launches are not a path's)
    study_phase(smi)
    # the bfloat16 paths ran K2 and K3 on bfloat16 costs, K1 never
    assert bf16_launches["fused_conv3d"] == 0, bf16_launches
    for name in ("fused_soft_argmin", "fused_soft_argmin_backward",
                 "fused_upsample_soft_argmin"):
        assert bf16_launches[name] > 0, (name, bf16_launches)
        launches[name] += bf16_launches[name]
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
            row_name, label, block = BF16_SOURCES[name]
            assert micro_bf16[name] > 0, f"{row_name} never launched"
            rows.append({"name": row_name, "route": "cuda",
                         "source": block, "replaces": replaces,
                         "launches": micro_bf16[name],
                         "unit": "per microbench case set (3 cases, pack 4, "
                                 "bfloat16)",
                         "max_abs_err": bf16_check[label],
                         "plain_ms": bf16_check["plain_ms"],
                         **bf16_times[label]})
        if name == "conv3d_packed_s1":
            # K4's bfloat16 route at pack 1 on the bfloat16 model's paths
            assert bf16_launches[name] > 0, "K4 bf16 never ran the trunk"
            rows.append({"name": "conv3d_packed_s1_bf16_pack1",
                         "route": "cuda", "source": block,
                         "replaces": replaces,
                         "launches": bf16_launches[name], **bf16_trunk})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all; "
          f"{smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
