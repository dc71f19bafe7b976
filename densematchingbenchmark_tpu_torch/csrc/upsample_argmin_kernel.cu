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
// (48 x 96 x 312 floats, 5.75 MB) stays in the 50 MB L2 and the output is
// one float per pixel. The floor is the exponentials: one per upsampled
// cost, 384 x 1248 x 192 = 92 M per launch on the PSMNet path, which the
// special-function units (MUFU.EX2, 16 a clock per SM) take 0.022 ms to do
// at 1.98 GHz; the lerps and sums beside them take about as long again on
// the FMA pipes, so the kernel is bound by instructions issued, not bytes.
//
// The design (redesigned from one thread per pixel, which read 192 taps
// from L2 and branched per depth in an online softmax):
// - A block owns a tile of TY = 16 output rows x TX = 64 output columns of
//   one batch item; each of its 128 threads owns one column and RPT = 8
//   consecutive rows, so the depth tables read at each step serve eight
//   pixels. Before any arithmetic the block stages the low-resolution
//   patch its tile reads (all D' depths x the source rows and columns under
//   the tile: 48 x 6 x 18 floats on the path), scaled by alpha * log2(e),
//   into shared memory, a warp a source row with 16 rows' loads in flight
//   at once; the bilinear (H, W) taps then read shared memory at offsets
//   fixed per pixel. The tap tables of all three axes and the source
//   intervals are made on the host exactly as the reference makes them and
//   kept on the device by the wrapper, so the kernel has no shape
//   precondition: ragged tiles clamp their pixels to the last row or
//   column and skip the store, and a shape whose patch does not fit in
//   shared memory (a large downsampling in H or W, far from any model's
//   call) runs the same code with the taps read from device memory
//   (STAGED = false).
// - The softmax-expectation walks the D' - 1 source intervals once. The
//   upsampled depths j of interval k (those with i0(j) == k, consecutive)
//   have the costs q_j = fma(f_j, v(k + 1) - v(k), v(k)) in the log2
//   domain, from the two bilinear source values v held in registers: one
//   FMA each. q_j is monotone in f_j (an FMA rounds monotonically), so the
//   interval's exact maximum is at its first or last j; the running maximum
//   m moves to it with the sums rescaled by 2^(m_old - m), one EX2 an
//   interval and no branch. Each j then adds e = 2^(q_j - m) <= 1 (one FMA
//   and one MUFU.EX2) to the sum and e * v_j to the weighted sum, with no
//   branch. Taking the maximum in a pass of its own instead recomputed
//   every column for it, a large share of the kernel's time. The
//   exact maximum, not a bound from the source values, keeps the largest
//   exponential at 1 for any cost scale.

#include <cuda_runtime.h>
#include <math.h>

#include "tma_ring.cuh"    // allow_smem: the per-device shared-memory limit

namespace {

constexpr int TY = 16;            // output rows per block
constexpr int TX = 64;            // output columns per block
constexpr int RPT = 8;            // output rows per thread
constexpr int NT = TX * TY / RPT; // threads per block: 128
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may have
constexpr int STAGE_ROWS = 16;    // patch rows a warp loads at once
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lerp(float a, float b, float f) {
  return fmaf(f, b - a, a);
}

// Shared memory ahead of the patch: the interval table (an int4 per
// source interval) and each upsampled depth's (weight, sample value).
__host__ __device__ constexpr int table_bytes(int Din, int Dout) {
  return 16 * Din + 8 * Dout;
}

// dtab, htab, wtab: an int4 per output index (i0, i1, weight bits and, in
// dtab, sample-value bits); itab: an int4 per source interval k (the first
// and one past the last upsampled depth whose i0 is k, the weights of the
// two as float bits)
template <bool STAGED>
__global__ void __launch_bounds__(NT)
upsample_soft_argmin_kernel(const float* __restrict__ low,
                            const int4* __restrict__ dtab,
                            const int4* __restrict__ itab,
                            const int4* __restrict__ htab,
                            const int4* __restrict__ wtab,
                            float* __restrict__ out, int Din, int Hin,
                            int Win, int Dout, int Hout, int Wout, int SR,
                            int SC, float scale) {
  extern __shared__ int4 smem4[];
  const int intervals = Din > 1 ? Din - 1 : 1;
  int4* const sint = smem4;                                // [intervals]
  float2* const sfv = reinterpret_cast<float2*>(sint + Din);  // [Dout]
  float* const patch = reinterpret_cast<float*>(sfv + Dout);
  const int t = threadIdx.x;
  const int tiles_w = (Wout + TX - 1) / TX;
  const int tiles = ((Hout + TY - 1) / TY) * tiles_w;
  const int tile = blockIdx.x % tiles;
  const int b = blockIdx.x / tiles;
  const int y0 = (tile / tiles_w) * TY;
  const int x0 = (tile % tiles_w) * TX;
  const int plane = Hin * Win;
  const float* const src = low + (long long)b * Din * plane;

  // the patch's first source row and column (taps are nondecreasing);
  // the patch is staged scaled by alpha * log2(e), a warp a source row,
  // its lanes along the row, with the loads of STAGE_ROWS rows in flight
  // before any is stored
  const int r0 = STAGED ? __ldg(&htab[y0].x) : 0;
  const int c0 = STAGED ? __ldg(&wtab[x0].x) : 0;
  const int rstride = STAGED ? SC : Win;
  const int pstride = STAGED ? SR * SC : plane;
  if (STAGED) {
    const int nr = __ldg(&htab[min(y0 + TY, Hout) - 1].y) - r0 + 1;
    const int nc = __ldg(&wtab[min(x0 + TX, Wout) - 1].y) - c0 + 1;
    constexpr int WARPS = NT / 32;
    for (int c = t % 32; c < nc; c += 32) {
      for (int kr0 = t / 32; kr0 < Din * nr; kr0 += WARPS * STAGE_ROWS) {
        float v[STAGE_ROWS];
#pragma unroll
        for (int u = 0; u < STAGE_ROWS; ++u) {
          const int kr = kr0 + u * WARPS;   // source depth k, row r
          const int k = kr / nr;
          v[u] = kr < Din * nr
                     ? __ldg(src + k * plane + (r0 + kr - k * nr) * Win +
                             c0 + c)
                     : 0.f;
        }
#pragma unroll
        for (int u = 0; u < STAGE_ROWS; ++u) {
          const int kr = kr0 + u * WARPS;
          const int k = kr / nr;
          if (kr < Din * nr)
            patch[(k * SR + kr - k * nr) * SC + c] = v[u] * scale;
        }
      }
    }
  }
  // the depth tables
  for (int k = t; k < intervals; k += NT) sint[k] = __ldg(itab + k);
  for (int j = t; j < Dout; j += NT) {
    const int4 tap = __ldg(dtab + j);
    sfv[j] = make_float2(__int_as_float(tap.z), __int_as_float(tap.w));
  }
  __syncthreads();
  const float* const base = STAGED ? patch : src;

  // this thread's pixels, clamped into the image (stores are masked)
  const int xo = x0 + t % TX;
  const int4 wt = __ldg(&wtab[min(xo, Wout - 1)]);
  const int cx0 = wt.x - c0, cx1 = wt.y - c0;
  const float fx = __int_as_float(wt.z);
  const int yb = y0 + (t / TX) * RPT;
  // offsets of each pixel's four taps in a source depth's plane: in bytes
  // in the staged patch (an LDS then takes register + uniform base), in
  // elements in device memory
  constexpr int ES = STAGED ? 4 : 1;
  int o00[RPT], o01[RPT], o10[RPT], o11[RPT];
  float fy[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int4 ht = __ldg(&htab[min(yb + i, Hout - 1)]);
    o00[i] = ES * ((ht.x - r0) * rstride + cx0);
    o01[i] = ES * ((ht.x - r0) * rstride + cx1);
    o10[i] = ES * ((ht.y - r0) * rstride + cx0);
    o11[i] = ES * ((ht.y - r0) * rstride + cx1);
    fy[i] = __int_as_float(ht.z);
  }

  // alpha * log2(e) * bilinear (H, W) value of source depth k, per pixel
  auto column = [&](int k, float (&v)[RPT]) {
    const float* const p = base + (long long)k * pstride;
    auto at = [&](int off) {
      return STAGED ? *reinterpret_cast<const float*>(
                          reinterpret_cast<const char*>(p) + off)
                    : __ldg(p + off);
    };
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      v[i] = lerp(lerp(at(o00[i]), at(o10[i]), fy[i]),
                  lerp(at(o01[i]), at(o11[i]), fy[i]), fx);
      if (!STAGED) v[i] *= scale;
    }
  };

  // One walk over the source intervals. Interval k's costs (log2 domain)
  // are q_j = fma(f_j, v(k + 1) - v(k), v(k)), monotone in f_j (an FMA
  // rounds monotonically), so their exact maximum is at the first or last
  // j. The running maximum m moves to it, rescaling the sums by
  // 2^(m_old - m) (one EX2 an interval), and every j adds e_j = 2^(q_j - m)
  // <= 1 with one FMA and one EX2, with no branch.
  float m[RPT], l[RPT], s[RPT], v0[RPT], v1[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    s[i] = 0.f;
  }
  column(0, v0);
#pragma unroll 1
  for (int k = 0; k < intervals; ++k) {
    const int4 iv = sint[k];
    column(min(k + 1, Din - 1), v1);
    if (iv.x < iv.y) {                      // uniform over the block
      const float fa = __int_as_float(iv.z), fb = __int_as_float(iv.w);
      float d[RPT], u[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        d[i] = v1[i] - v0[i];
        const float mk = fmaxf(m[i], fmaxf(fmaf(fa, d[i], v0[i]),
                                           fmaf(fb, d[i], v0[i])));
        const float r = ex2(m[i] - mk);     // 0 at the first interval
        l[i] *= r;
        s[i] *= r;
        m[i] = mk;
        u[i] = v0[i] - mk;
      }
#pragma unroll 2
      for (int j = iv.x; j < iv.y; ++j) {
        const float2 fv = sfv[j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float e = ex2(fmaf(fv.x, d[i], u[i]));
          l[i] += e;
          s[i] = fmaf(e, fv.y, s[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) v0[i] = v1[i];
  }
  if (xo >= Wout) return;
  float* const o = out + (long long)b * Hout * Wout + xo;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    if (yb + i < Hout) o[(long long)(yb + i) * Wout] = s[i] / l[i];
}

}  // namespace

// low [B, Din, Hin, Win] float32; tap tables dtab [Dout], htab [Hout],
// wtab [Wout] of int4 (i0, i1, weight and, in dtab, sample value as float
// bits) and the interval table itab [max(Din - 1, 1)] (see the kernel);
// out [B, Hout, Wout]. All contiguous on the device, B * tiles and
// every index within int range (checked by the caller). SR x SC: the
// largest source patch (rows x columns) of one output tile, from the same
// tables; staged != 0 stages Din x SR x SC floats (smem bytes) in shared
// memory. Returns the CUDA error code of the launch.
extern "C" int upsample_soft_argmin_f32(const float* low, const void* dtab,
                                        const void* itab, const void* htab,
                                        const void* wtab,
                                        float* out, int B, int Din, int Hin,
                                        int Win, int Dout, int Hout, int Wout,
                                        int SR, int SC, int staged, int smem,
                                        float alpha, void* stream) {
  const long long tiles =
      (long long)((Hout + TY - 1) / TY) * ((Wout + TX - 1) / TX);
  const unsigned blocks = (unsigned)(tiles * B);
  const float scale = alpha * LOG2E;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* d = static_cast<const int4*>(dtab);
  const int4* it = static_cast<const int4*>(itab);
  const int4* h = static_cast<const int4*>(htab);
  const int4* w = static_cast<const int4*>(wtab);
  const int tables = table_bytes(Din, Dout);
  if (staged) {
    smem += tables;
    if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
    static int allowed[tma_ring::MAX_DEVICES];
    const cudaError_t attr = tma_ring::allow_smem(
        upsample_soft_argmin_kernel<true>, MAX_SMEM, allowed);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    upsample_soft_argmin_kernel<true><<<blocks, NT, smem, s>>>(
        low, d, it, h, w, out, Din, Hin, Win, Dout, Hout, Wout, SR, SC, scale);
  } else {
    if (tables > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
    if (tables > 48 * 1024) {
      static int allowed[tma_ring::MAX_DEVICES];
      const cudaError_t attr = tma_ring::allow_smem(
          upsample_soft_argmin_kernel<false>, MAX_SMEM, allowed);
      if (attr != cudaSuccess) return static_cast<int>(attr);
    }
    upsample_soft_argmin_kernel<false><<<blocks, NT, tables, s>>>(
        low, d, it, h, w, out, Din, Hin, Win, Dout, Hout, Wout, SR, SC, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
