// 3x3x3 stride-1 SAME conv3d on the D-packed volume layout, with a fused
// per-packed-channel scale/bias (+ReLU) epilogue: float32 in and out on the
// CUDA cores (packed_conv3d_f32), or bfloat16 operands and output on the
// tensor cores with float32 sums and epilogue (packed_conv3d_bf16).
//
// Replaces the TPU kernel densematchingbenchmark_tpu/ops/pallas/
// packed_conv3d_kernel.py::conv3d_packed_s1_pallas (body _kernel, launched
// from _forward): the stride-1 trunk conv of the training path. The packed
// layout is xp[b, r, h, w, p * Ci + c] = x[b, r * P + p, h, w, c] for
// P = pack (pack 1 is plain NDHWC); the output is packed the same way.
//
// The TPU kernel widens its lanes by packing depth into channels and pays
// for it with a windowed weight matrix; on Hopper lane width costs nothing,
// so both routes do only the true MACs and take the packing as addressing:
// input depth z at packed row z / P, slot z % P, output depth d at row
// d / P, slot d % P, the epilogue's scale and bias by the same packed
// channel.
// - float32: the float32 block on the CUDA cores that K1 runs too
//   (conv3d_tile.cuh, which says what bounds it and how the design meets
//   it), with the caller's launch plan.
// - bfloat16: the wgmma block of conv3d_wgmma_persistent.cuh on a
//   persistent grid: about one block per SM for each Cout tile, each
//   fetching its weights once and walking a contiguous share of the output,
//   depth fastest, each input plane of a run of depths staged once through
//   the TMA ring for the three outputs it feeds (ops/cuda/
//   packed_conv3d_kernel.py::wgmma_plan). That header says what bounds it
//   and why it walks so.

#include "conv3d_tile.cuh"
#include "conv3d_wgmma_persistent.cuh"

// xp [B, R, H, W, P*Cin] and out [B, R, H, W, P*Cout] float32; w the
// wrapper's image of the true kernel [3, 3, 3, Cin, Cout]
// (ops/cuda/packed_conv3d_kernel.py::conv3d_f32_weights); scale / bias
// [P*Cout] float32; all contiguous, 16-byte aligned, with Cin % 4 == 0 and
// Cout % 4 == 0 (checked by the caller); the launch plan's Cout tile cob,
// rows a block th, tiles, ring stages, blocks and dynamic shared memory
// bytes (conv3d_f32_plan). Returns the CUDA error code of the launch
// (cudaErrorInvalidValue, launching nothing, for a plan the block cannot
// take), or 999 / 1000 + the CUresult when the TMA tensor map cannot be
// made.
extern "C" int packed_conv3d_f32(const float* x, const float* w,
                                 const float* scale, const float* bias,
                                 float* out, int B, int R, int P, int H,
                                 int W, int Cin, int Cout, int relu, int cob,
                                 int th, int tiles_h, int tiles_w, int stages,
                                 int blocks, int smem, void* stream) {
  const conv3d_tile::Geometry g{B, R, P, H, W, Cin, Cout, relu,
                                th, tiles_h, tiles_w, stages};
  return conv3d_tile::launch(x, w, scale, bias, out, g, cob, blocks, smem,
                             stream);
}

// Blocks of the float32 kernel with Cout tile cob resident on an SM of the
// current device at th rows a block and smem bytes, or minus the CUDA error
// code.
extern "C" int packed_conv3d_f32_residency(int cob, int th, int smem) {
  return conv3d_tile::residency(cob, th, smem);
}

// Registers a thread of the float32 kernel with Cout tile cob, or minus the
// CUDA error code.
extern "C" int packed_conv3d_f32_regs(int cob) {
  return conv3d_tile::registers(cob);
}

// The same function in bfloat16 (x, out, and w as the wrapper's
// shared-memory image of the kernel, ops/cuda/packed_conv3d_kernel.py::
// wgmma_weights), on the tensor cores: `dims` holds the shapes, ReLU and
// the caller's launch plan (conv3d_wgmma_persistent::Dim: channel slice
// ck, ring stages, tiles, blocks / Cout tiles persistent blocks for each
// Cout tile, dynamic shared memory bytes). Needs Cin % 16 == 0, Cout % 8 ==
// 0 and 16-byte aligned operands (checked by the caller). Returns the CUDA
// error code of the launch (cudaErrorInvalidValue, launching nothing, when
// smem is short of the block's layout or the grid does not fit the work),
// or 999 / 1000 + the CUresult when the TMA tensor map cannot be made.
extern "C" int packed_conv3d_bf16(const __nv_bfloat16* x,
                                  const __nv_bfloat16* w, const float* scale,
                                  const float* bias, __nv_bfloat16* out,
                                  const int* dims, void* stream) {
  return conv3d_wgmma_persistent::launch(x, w, scale, bias, out, dims,
                                         stream);
}

// Registers a thread of the packed_conv3d_bf16 kernel of channel slice ck
// (16, 32 or 64), for the launch plan's residency; minus the CUDA error
// code when they cannot be read.
extern "C" int packed_conv3d_bf16_regs(int ck) {
  return conv3d_wgmma_persistent::registers(ck);
}
