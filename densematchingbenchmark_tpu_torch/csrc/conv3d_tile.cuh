// One block of the float32 3x3x3 stride-1 SAME conv3d with a fused
// per-channel scale/bias (+ReLU) epilogue: the implicit GEMM shared by
// conv3d_kernel.cu (K1, plain NDHWC) and packed_conv3d_kernel.cu (K4, the
// D-packed layout).
//
// Layout: the input is read as xp[b, r, h, w, p * Cin + c] = x[b, r * P + p,
// h, w, c] for P = pack and the output written the same way with Cout, so
// P = 1 is plain NDHWC; scale and bias hold P * Cout packed channels.
//
// What bounds it on an H100: arithmetic. At the trunk's shapes a unit does
// 2*27*Cin*Cout flops per output voxel against (Cin + Cout) * 4 bytes of
// activations, i.e. 2-4 Kflop per 1 KB, far above the card's f32
// flop-per-byte ratio, so the float32 FMA rate (67 TFLOP/s without the
// tensor cores) is the ceiling for this float32 route.
//
// What the design does about it: an implicit GEMM on the CUDA cores with a
// register tile of 4 output voxels x 8 output channels per thread (32 FMAs
// per 6 shared-memory loads). A block owns a 4 x 32 (rows x columns) output
// tile of one depth slice and 32 output channels. For each depth tap and
// each 16-channel slice of Cin it stages the zero-masked (4+2) x (32+2) halo
// and the 9 (dh, dw) weight taps of that slice in shared memory (13.9 KB +
// 18.4 KB), so every input value loaded from device memory feeds 9 taps x 32
// channels. The halo is masked at every border instead of padding a copy of
// the volume, and ragged H / W / Cin / Cout edges are masked, so any shape
// with Cin % 4 == 0 and Cout % 4 == 0 runs. The packing is pure addressing:
// input depth z is read at packed row z / P, channel offset (z % P) * Cin,
// and output depth d written at row d / P, offset (d % P) * Cout, so no
// padded, unpacked or widened copy of a packed volume is made. A later
// revision moves the contraction onto wgmma (TF32 / bf16) with a TMA
// pipeline.

#pragma once

#include <cuda_runtime.h>

namespace conv3d_tile {

constexpr int TH = 4;            // output rows per block
constexpr int TW = 32;           // output columns per block
constexpr int CO_B = 32;         // output channels per block
constexpr int CK = 16;           // input channels staged per step
constexpr int NT = 128;          // threads per block: 32 columns x 4 groups
constexpr int HR = TH + 2;       // halo rows
constexpr int HC = TW + 2;       // halo columns
constexpr int XS = CK + 1;       // smem floats per halo position (+1: banks)
constexpr int CO_T = 8;          // output channels per thread

// Grid of a launch: (row and column tiles, B * R * P, Cout blocks).
inline dim3 grid(int B, int D, int H, int W, int Cout) {
  return dim3(((H + TH - 1) / TH) * ((W + TW - 1) / TW), B * D,
              (Cout + CO_B - 1) / CO_B);
}

// The block (blockIdx.x: H/W tile, blockIdx.y: b * D + d with D = R * P,
// blockIdx.z: Cout block) of the conv of x [B, R, H, W, P*Cin] with w
// [3, 3, 3, Cin, Cout] into out [B, R, H, W, P*Cout].
__device__ __forceinline__ void run(const float* __restrict__ x,
                                    const float* __restrict__ w,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ bias,
                                    float* __restrict__ out, int R, int P,
                                    int H, int W, int Cin, int Cout,
                                    int relu) {
  __shared__ float in_s[HR * HC * XS];
  __shared__ __align__(16) float w_s[9 * CK * CO_B];

  const int D = R * P;           // true depth
  const int t = threadIdx.x;
  const int cg = t & 3;          // channel group: CO_T channels
  const int vx = t >> 2;         // output column within the tile
  const int tiles_w = (W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int bd = blockIdx.y;     // b * D + d
  const int d = bd % D;
  const int b = bd / D;
  const int co0 = blockIdx.z * CO_B;
  const long long in_vox = (long long)P * Cin;    // floats per packed voxel
  const long long out_vox = (long long)P * Cout;

  float acc[TH][CO_T];
#pragma unroll
  for (int i = 0; i < TH; ++i)
#pragma unroll
    for (int j = 0; j < CO_T; ++j) acc[i][j] = 0.f;

  for (int dd = 0; dd < 3; ++dd) {
    const int z = d + dd - 1;
    if (z < 0 || z >= D) continue;           // uniform over the block
    // packed row z / P, slot z % P
    const long long plane = ((long long)b * R + z / P) * H;
    const float* xs = x + (z % P) * Cin;
    for (int c0 = 0; c0 < Cin; c0 += CK) {
      __syncthreads();                       // previous step's readers done
      // halo of this depth tap and channel slice, zero outside the volume
      for (int e = t; e < HR * HC * (CK / 4); e += NT) {
        const int q = e % (CK / 4);
        const int pos = e / (CK / 4);
        const int yy = y0 + pos / HC - 1;
        const int xx = x0 + pos % HC - 1;
        const int c = c0 + q * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (yy >= 0 && yy < H && xx >= 0 && xx < W && c < Cin)
          v = *reinterpret_cast<const float4*>(
              xs + ((plane + yy) * W + xx) * in_vox + c);
        float* s = in_s + pos * XS + q * 4;
        s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
      }
      // the 9 (dh, dw) taps of depth tap dd for this channel slice
      for (int e = t; e < 9 * CK * (CO_B / 4); e += NT) {
        const int q = e % (CO_B / 4);
        const int rest = e / (CO_B / 4);
        const int c = rest % CK;
        const int tap = rest / CK;
        const int ci = c0 + c;
        const int co = co0 + q * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ci < Cin && co < Cout)
          v = *reinterpret_cast<const float4*>(
              w + ((long long)(dd * 9 + tap) * Cin + ci) * Cout + co);
        *reinterpret_cast<float4*>(w_s + (tap * CK + c) * CO_B + q * 4) = v;
      }
      __syncthreads();

#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dh = tap / 3;
        const int dw = tap % 3;
#pragma unroll 4
        for (int c = 0; c < CK; ++c) {
          float a[TH];
#pragma unroll
          for (int i = 0; i < TH; ++i)
            a[i] = in_s[((i + dh) * HC + vx + dw) * XS + c];
          const float* wr = w_s + (tap * CK + c) * CO_B + cg * CO_T;
          const float4 w0 = *reinterpret_cast<const float4*>(wr);
          const float4 w1 = *reinterpret_cast<const float4*>(wr + 4);
#pragma unroll
          for (int i = 0; i < TH; ++i) {
            acc[i][0] = fmaf(a[i], w0.x, acc[i][0]);
            acc[i][1] = fmaf(a[i], w0.y, acc[i][1]);
            acc[i][2] = fmaf(a[i], w0.z, acc[i][2]);
            acc[i][3] = fmaf(a[i], w0.w, acc[i][3]);
            acc[i][4] = fmaf(a[i], w1.x, acc[i][4]);
            acc[i][5] = fmaf(a[i], w1.y, acc[i][5]);
            acc[i][6] = fmaf(a[i], w1.z, acc[i][6]);
            acc[i][7] = fmaf(a[i], w1.w, acc[i][7]);
          }
        }
      }
    }
  }

  // epilogue: out = acc * scale + bias per packed channel, optional ReLU
  const int xx = x0 + vx;
  if (xx >= W) return;
  const long long out_plane = ((long long)b * R + d / P) * H;
  const int slot = (d % P) * Cout;
#pragma unroll
  for (int g = 0; g < CO_T / 4; ++g) {
    const int co = co0 + cg * CO_T + g * 4;
    if (co >= Cout) continue;                // Cout % 4 == 0: all 4 or none
    const float4 s = *reinterpret_cast<const float4*>(scale + slot + co);
    const float4 o = *reinterpret_cast<const float4*>(bias + slot + co);
#pragma unroll
    for (int i = 0; i < TH; ++i) {
      const int yy = y0 + i;
      if (yy >= H) break;
      float4 v;
      v.x = fmaf(acc[i][g * 4 + 0], s.x, o.x);
      v.y = fmaf(acc[i][g * 4 + 1], s.y, o.y);
      v.z = fmaf(acc[i][g * 4 + 2], s.z, o.z);
      v.w = fmaf(acc[i][g * 4 + 3], s.w, o.w);
      if (relu) {
        v.x = fmaxf(v.x, 0.f); v.y = fmaxf(v.y, 0.f);
        v.z = fmaxf(v.z, 0.f); v.w = fmaxf(v.w, 0.f);
      }
      *reinterpret_cast<float4*>(
          out + ((out_plane + yy) * W + xx) * out_vox + slot + co) = v;
    }
  }
}

}  // namespace conv3d_tile
