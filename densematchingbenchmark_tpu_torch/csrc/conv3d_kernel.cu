// 3x3x3 stride-1 SAME conv3d in NDHWC with a fused per-channel
// scale/bias (+ReLU) epilogue, float32 in and out.
//
// Replaces the TPU kernel densematchingbenchmark_tpu/ops/pallas/
// conv3d_kernel.py::fused_conv3d (body _kernel): the eval-mode
// conv + folded-BatchNorm (+ReLU) unit of the PSMNet aggregation trunk.
//
// The block is conv3d_tile::run with pack 1; conv3d_tile.cuh says what
// bounds it on an H100 (the f32 FMA rate) and how the design meets it.

#include "conv3d_tile.cuh"

namespace {

__global__ void __launch_bounds__(conv3d_tile::NT)
conv3d_bn_act_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int D, int H, int W, int Cin, int Cout, int relu) {
  conv3d_tile::run(x, w, scale, bias, out, D, 1, H, W, Cin, Cout, relu);
}

}  // namespace

// x [B, D, H, W, Cin], w [3, 3, 3, Cin, Cout], scale / bias [Cout], out
// [B, D, H, W, Cout]; all float32, contiguous, 16-byte aligned, with
// Cin % 4 == 0, Cout % 4 == 0 and B * D <= 65535 (checked by the caller).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int conv3d_bn_act_f32(const float* x, const float* w,
                                 const float* scale, const float* bias,
                                 float* out, int B, int D, int H, int W,
                                 int Cin, int Cout, int relu, void* stream) {
  conv3d_bn_act_kernel<<<conv3d_tile::grid(B, D, H, W, Cout),
                         conv3d_tile::NT, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, w, scale, bias, out, D, H, W, Cin, Cout, relu);
  return static_cast<int>(cudaGetLastError());
}
