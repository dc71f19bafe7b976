// Trilinear (align_corners=True) upsample of a low-resolution cost volume
// fused with the soft-argmin over disparity, float32.
//
// Replaces the TPU kernel densematchingbenchmark_tpu/ops/pallas/
// upsample_argmin_kernel.py::fused_upsample_soft_argmin (body _kernel, taps
// from _interp_matrix): [B, D', H', W'] -> [B, H, W] expected disparity under
// softmax(alpha * upsample(cost)) over the out_d upsampled depths. The
// full-resolution volume (370 MB at 192 x 384 x 1248) is never written.
//
// What bounds it on an H100: not device memory. The low-resolution volume
// (48 x 96 x 312 floats, 5.7 MB) stays in the 50 MB L2 and the output is one
// float per pixel, so the floor is the arithmetic: per output pixel 3 * D'
// lerps to build the column, then out_d lerps, exps and multiply-adds for
// the softmax-expectation (92 M exps at 384 x 1248 x 192).
//
// What the design does about it: one thread per output pixel. The thread
// lerps the 2 x 2 (H, W) neighbourhood of each of the D' source depths once,
// keeping the column of D' values in shared memory (one column per thread,
// laid out so the 32 lanes of a warp hit 32 banks), then walks the out_d
// upsampled depths with a 2-tap lerp each and an online (running-max)
// softmax-expectation, so each upsampled cost costs one exp and is never
// stored. The tap tables of all three axes are computed on the host exactly
// as the reference computes them and passed in, so the kernel has no H % 8
// or other shape precondition.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 128;  // threads (= output pixels) per block

__global__ void __launch_bounds__(NT)
upsample_soft_argmin_kernel(const float* __restrict__ low,
                            const int* __restrict__ d_i0,
                            const int* __restrict__ d_i1,
                            const float* __restrict__ d_f,
                            const int* __restrict__ h_i0,
                            const int* __restrict__ h_i1,
                            const float* __restrict__ h_f,
                            const int* __restrict__ w_i0,
                            const int* __restrict__ w_i1,
                            const float* __restrict__ w_f,
                            const float* __restrict__ vals,
                            float* __restrict__ out, int B, int Din, int Hin,
                            int Win, int Dout, int Hout, int Wout,
                            float alpha) {
  extern __shared__ float smem[];
  float* col = smem;                                   // [Din][NT]
  int* sd0 = reinterpret_cast<int*>(col + Din * NT);   // [Dout]
  int* sd1 = sd0 + Dout;                               // [Dout]
  float* sdf = reinterpret_cast<float*>(sd1 + Dout);   // [Dout]
  float* sval = sdf + Dout;                            // [Dout]

  const int t = threadIdx.x;
  for (int j = t; j < Dout; j += NT) {
    sd0[j] = d_i0[j];
    sd1[j] = d_i1[j];
    sdf[j] = d_f[j];
    sval[j] = vals[j];
  }
  __syncthreads();

  const long long p = (long long)blockIdx.x * NT + t;
  if (p >= (long long)B * Hout * Wout) return;
  const int xo = p % Wout;
  const int yo = (p / Wout) % Hout;
  const int b = p / ((long long)Wout * Hout);

  const int y0 = h_i0[yo], y1 = h_i1[yo];
  const int x0 = w_i0[xo], x1 = w_i1[xo];
  const float fy = h_f[yo], fx = w_f[xo];
  const long long plane = (long long)Hin * Win;
  const float* src = low + (long long)b * Din * plane;
  for (int k = 0; k < Din; ++k) {
    const float* r0 = src + k * plane + (long long)y0 * Win;
    const float* r1 = src + k * plane + (long long)y1 * Win;
    const float top = __ldg(r0 + x0) * (1.f - fy) + __ldg(r1 + x0) * fy;
    const float bot = __ldg(r0 + x1) * (1.f - fy) + __ldg(r1 + x1) * fy;
    col[k * NT + t] = top * (1.f - fx) + bot * fx;
  }

  // online softmax-expectation over the out_d upsampled depths
  float m = -INFINITY, l = 0.f, s = 0.f;
  for (int j = 0; j < Dout; ++j) {
    const float f = sdf[j];
    const float c =
        (col[sd0[j] * NT + t] * (1.f - f) + col[sd1[j] * NT + t] * f) * alpha;
    if (c > m) {
      const float r = expf(m - c);
      l = l * r + 1.f;
      s = s * r + sval[j];
      m = c;
    } else {
      const float e = expf(c - m);
      l += e;
      s = fmaf(e, sval[j], s);
    }
  }
  out[p] = s / l;
}

}  // namespace

// low [B, Din, Hin, Win] float32; tap tables (i0, i1, frac) of length Dout,
// Hout, Wout; vals [Dout]; out [B, Hout, Wout]. All contiguous on the
// device (checked by the caller). Returns the CUDA error code of the launch.
extern "C" int upsample_soft_argmin_f32(
    const float* low, const int* d_i0, const int* d_i1, const float* d_f,
    const int* h_i0, const int* h_i1, const float* h_f, const int* w_i0,
    const int* w_i1, const float* w_f, const float* vals, float* out, int B,
    int Din, int Hin, int Win, int Dout, int Hout, int Wout, float alpha,
    void* stream) {
  const size_t smem = sizeof(float) * ((size_t)Din * NT + 4 * (size_t)Dout);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        upsample_soft_argmin_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long n = (long long)B * Hout * Wout;
  const unsigned blocks = (unsigned)((n + NT - 1) / NT);
  upsample_soft_argmin_kernel<<<blocks, NT, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      low, d_i0, d_i1, d_f, h_i0, h_i1, h_f, w_i0, w_i1, w_f, vals, out, B,
      Din, Hin, Win, Dout, Hout, Wout, alpha);
  return static_cast<int>(cudaGetLastError());
}
