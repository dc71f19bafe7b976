// 3x3x3 stride-1 SAME conv3d on the D-packed volume layout, with a fused
// per-packed-channel scale/bias (+ReLU) epilogue: float32 in and out
// (packed_conv3d_f32), or bfloat16 operands and output with float32 sums and
// epilogue (packed_conv3d_bf16).
//
// Replaces the TPU kernel densematchingbenchmark_tpu/ops/pallas/
// packed_conv3d_kernel.py::conv3d_packed_s1_pallas (body _kernel, launched
// from _forward): the stride-1 trunk conv of the training path. The packed
// layout is xp[b, r, h, w, p * Ci + c] = x[b, r * P + p, h, w, c] for
// P = pack (pack 1 is plain NDHWC); the output is packed the same way.
//
// The TPU kernel widens its lanes by packing depth into channels and pays
// for it with a windowed weight matrix; on the CUDA cores lane width costs
// nothing, so this kernel does only the true MACs with K1's implicit-GEMM
// block (conv3d_tile::run, which says what bounds it and how the design
// meets it) and takes the packing as addressing: input depth z at packed
// row z / P, slot z % P, output depth d at row d / P, slot d % P, the
// epilogue's scale and bias by the same packed channel.

#include "conv3d_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(conv3d_tile::NT)
packed_conv3d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ out,
                     int R, int P, int H, int W, int Cin, int Cout,
                     int relu) {
  conv3d_tile::run(x, w, scale, bias, out, R, P, H, W, Cin, Cout, relu);
}

template <typename T>
int launch(const T* x, const T* w, const float* scale, const float* bias,
           T* out, int B, int R, int P, int H, int W, int Cin, int Cout,
           int relu, void* stream) {
  packed_conv3d_kernel<T><<<conv3d_tile::grid(B, R * P, H, W, Cout),
                            conv3d_tile::NT, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, w, scale, bias, out, R, P, H, W, Cin, Cout, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xp [B, R, H, W, P*Cin], w [3, 3, 3, Cin, Cout] (true, unpacked), out
// [B, R, H, W, P*Cout], all of one type (float32 or bfloat16); scale / bias
// [P*Cout] float32; all contiguous, 16-byte aligned, with Cin % 4 == 0,
// Cout % 4 == 0 and B * R * P <= 65535 (checked by the caller). Returns the
// CUDA error code of the launch (0 on success).
extern "C" int packed_conv3d_f32(const float* x, const float* w,
                                 const float* scale, const float* bias,
                                 float* out, int B, int R, int P, int H,
                                 int W, int Cin, int Cout, int relu,
                                 void* stream) {
  return launch(x, w, scale, bias, out, B, R, P, H, W, Cin, Cout, relu,
                stream);
}

extern "C" int packed_conv3d_bf16(const __nv_bfloat16* x,
                                  const __nv_bfloat16* w, const float* scale,
                                  const float* bias, __nv_bfloat16* out,
                                  int B, int R, int P, int H, int W, int Cin,
                                  int Cout, int relu, void* stream) {
  return launch(x, w, scale, bias, out, B, R, P, H, W, Cin, Cout, relu,
                stream);
}
