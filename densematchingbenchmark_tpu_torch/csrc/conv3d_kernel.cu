// 3x3x3 stride-1 SAME conv3d in NDHWC with a fused per-channel
// scale/bias (+ReLU) epilogue, float32 in and out.
//
// Replaces the TPU kernel densematchingbenchmark_tpu/ops/pallas/
// conv3d_kernel.py::fused_conv3d (body _kernel): the eval-mode
// conv + folded-BatchNorm (+ReLU) unit of the PSMNet aggregation trunk.
//
// The block is conv3d_tile.cuh's float32 block with pack 1, the one K4's
// float32 route runs; that header says what bounds it on an H100 (the f32
// FMA rate) and how the design meets it.

#include "conv3d_tile.cuh"

// x [B, D, H, W, Cin], w the wrapper's image of the kernel
// (ops/cuda/packed_conv3d_kernel.py::conv3d_f32_weights), scale / bias
// [Cout], out [B, D, H, W, Cout]; all float32, contiguous, 16-byte aligned,
// with Cin % 4 == 0 and Cout % 4 == 0 (checked by the caller); the launch
// plan's Cout tile cob, rows a block th, tiles, ring stages, blocks and
// dynamic shared memory bytes (conv3d_f32_plan). Returns the CUDA error
// code of the launch (cudaErrorInvalidValue, launching nothing, for a plan
// the block cannot take), or 999 / 1000 + the CUresult when the TMA tensor
// map cannot be made.
extern "C" int conv3d_bn_act_f32(const float* x, const float* w,
                                 const float* scale, const float* bias,
                                 float* out, int B, int D, int H, int W,
                                 int Cin, int Cout, int relu, int cob, int th,
                                 int tiles_h, int tiles_w, int stages,
                                 int blocks, int smem, void* stream) {
  const conv3d_tile::Geometry g{B, D, 1, H, W, Cin, Cout, relu,
                                th, tiles_h, tiles_w, stages};
  return conv3d_tile::launch(x, w, scale, bias, out, g, cob, blocks, smem,
                             stream);
}

// Blocks of the kernel with Cout tile cob resident on an SM of the current
// device at th rows a block and smem bytes, or minus the CUDA error code.
extern "C" int conv3d_bn_act_f32_residency(int cob, int th, int smem) {
  return conv3d_tile::residency(cob, th, smem);
}

// Registers a thread of the kernel with Cout tile cob, or minus the CUDA
// error code.
extern "C" int conv3d_bn_act_f32_regs(int cob) {
  return conv3d_tile::registers(cob);
}
