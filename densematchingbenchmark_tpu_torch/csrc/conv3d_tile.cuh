// The float32 3x3x3 stride-1 SAME conv3d with a fused per-channel
// scale/bias (+ReLU) epilogue on the CUDA cores: one block, shared by
// conv3d_kernel.cu (K1, plain NDHWC, the eval trunk) and
// packed_conv3d_kernel.cu (K4's float32 route, the D-packed layout, the
// training trunk). The load and store helpers are shared with K5's float32
// route (packed_conv3d_v2_kernel.cu); the bfloat16 routes are
// conv3d_wgmma.cuh.
//
// Layout: the input is read as xp[b, r, h, w, p * Cin + c] = x[b, r * P + p,
// h, w, c] for P = pack and the output written the same way with Cout, so
// P = 1 is plain NDHWC; scale and bias hold P * Cout packed channels. The
// packing is addressing: input depth z at packed row z / P, slot z % P.
//
// What bounds it on an H100: arithmetic, 2 * 27 * Cin * Cout flops per
// output voxel against (Cin + Cout) * 4 bytes of activations, far above
// the card's float32 flop-per-byte ratio, so the float32 FMA rate of the
// CUDA cores (67 TFLOP/s; TF32 is outside the float32 contract) is the
// ceiling. An SM issues one warp instruction a clock on each of its four
// schedulers, so every instruction that is not an FMA (a shared load, an
// address, a barrier) takes the place of one; and the loads' latency has
// to hide behind the FMAs of the same or other warps.
//
// The design:
// - Staging is off the FMA warps. A stage is one (input plane, 8-channel
//   slice): its (TH + 2) x (32 + 2) x 8 halo arrives by one TMA copy from a
//   5-D tensor map over the packed volume seen as [B * R, H, W, P, Cin]
//   (box [8, 1, 34, TH + 2, 1]; out-of-bounds elements are zero-filled,
//   which is the SAME halo at every H / W border and zeroes the channels
//   past Cin of a ragged slice), and the slice's 9 (dh, dw) taps x 8 x COB
//   weights of that depth tap by one bulk copy of the wrapper's image
//   (conv3d_f32_weights: [Cout tiles, 3, Cin slices, 9, 8, COB], zero past
//   Cin and Cout). Stages ride a 2-3 slot ring; a slot's full mbarrier
//   (tma_ring.cuh) completes when its bytes have landed. No warp waits to
//   refill a slot: each warp counts itself out of a slot when it has read
//   it (a shared-memory counter), and the warp that counts last issues the
//   slot's next stage. (With thread 0 waiting on an "empty" mbarrier for
//   every warp before each refill, as K5's ring does, clock64 stamps on the
//   card showed its warp waiting for the others and the others waiting for
//   the stages it refilled late, for a large share of the block's time.)
//   So the next stages land while this one computes, and no thread
//   computes a staging address or mask.
// - The inner loop: a thread sums 1 output row x 16 consecutive columns x
//   4 output channels (64 accumulators). For each (dh, 4-channel quad) it
//   loads the 18 input positions of its row segment once (18 16-byte
//   shared loads) and reuses them from registers across the three dw taps
//   (a register window along W); per (dw, channel) one 16-byte load fetches
//   its 4 output channels' weights, the same for the block's rows and
//   columns. That is 768 FMAs per 30 shared loads, 25.6 FMAs a load. What
//   separates it from the FMA rate is the bytes the shared loads return to
//   registers (a warp-wide 16-byte load returns 512 bytes, whatever its
//   addresses), the weights' most. In throwaway builds on the card, one
//   that loaded each (dh, quad)'s weights once (a wrong result) ran far
//   closer to the bound, while a warp-uniform weight address,
//   conflict-free window loads and an explicit prefetch of the next
//   weights each changed nothing. Of the thread tiles of 64 accumulators,
//   16 columns x 4 channels returns the fewest bytes per FMA (13 % fewer
//   than 8 x 8) and ran fastest. The block may take up to 255 registers a
//   thread (ptxas gives it about 230, for the 18-position window), so a
//   128-thread block runs two an SM; capped at 128 registers the kernel
//   ran slower.
// - One block covers all of Cout <= 64 (COB = 32 or 64 output channels, a
//   Cout tile per COB beyond), so each halo is staged once per stage and
//   not once per 32 channels. Threads: COB / 4 channel groups x 2 column
//   groups x TH rows, channel group fastest, so that a warp's weight loads
//   are consecutive 16-byte pieces of one weight row.
// - The launch plan (ops/cuda/packed_conv3d_kernel.py::conv3d_f32_plan,
//   pure Python) picks COB, the rows a block TH and the ring's stages per
//   layer to fill the card, with each candidate's blocks per SM read from
//   the built kernel (cudaOccupancyMaxActiveBlocksPerMultiprocessor, via
//   residency() below). The grid is 1-D, depth fastest, so the blocks of
//   neighbouring depths of one tile, which read the same input planes, run
//   together and the plane's second and third reads come from L2.
// Each output depth d reads its three input planes d - 1, d, d + 1 (those
// inside the volume), each with its depth tap's weights. Needs Cin % 4 ==
// 0 and Cout % 4 == 0 (TMA's 16-byte strides, the 16-byte epilogue
// stores); ragged H, W, D, Cin and Cout edges are masked.

#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>

#include <cstdint>

#include "tma_ring.cuh"

namespace conv3d_tile {

// Four consecutive float32 values: one 16-byte load (p 16-byte aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four float32 values: one 16-byte store.
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

constexpr int TW = 32;            // output columns per block
constexpr int CW = 16;            // output columns per thread
constexpr int CO_T = 4;           // output channels per thread
constexpr int CK = 8;             // input channels per stage
constexpr int HC = TW + 2;        // halo columns
constexpr int ALIGN = 128;        // TMA destination alignment
constexpr int MAX_THREADS = 256;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may have

// The launch geometry, as the wrapper's plan computed it: TH rows a block,
// tiles along H and W, Cout tiles of COB channels, ring stages.
struct Geometry {
  int B, R, P, H, W, Cin, Cout, relu;
  int th, tiles_h, tiles_w, stages;
};

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
__host__ __device__ constexpr int threads(int cob, int th) {
  return cob / CO_T * (TW / CW) * th;
}
// A stage: the weights (9 taps x CK x COB float32), then the halo box
// ((TH + 2) x HC x CK float32) from the next ALIGN boundary. After the
// stages, a full barrier (8 bytes) and a release counter (4 bytes, padded
// to 8) per stage; smem_bytes adds ALIGN bytes of slack for the first
// boundary.
__host__ __device__ constexpr int weight_bytes(int cob) {
  return 9 * CK * cob * 4;
}
__host__ __device__ constexpr int halo_bytes(int th) {
  return (th + 2) * HC * CK * 4;
}
__host__ __device__ constexpr int stage_bytes(int cob, int th) {
  return weight_bytes(cob) + round_up(halo_bytes(th), ALIGN);
}
__host__ __device__ constexpr int smem_bytes(int cob, int th, int stages) {
  return ALIGN + stages * stage_bytes(cob, th) + 16 * stages;
}
static_assert(weight_bytes(32) % ALIGN == 0, "stage layout");

// One stage's products: the staged halo `hs` at this thread's row and first
// column, and the weights `ws` at its channel group, into acc[column]
// [channel].
template <int COB>
__device__ __forceinline__ void compute_stage(const float* __restrict__ hs,
                                              const float* __restrict__ ws,
                                              float (&acc)[CW][CO_T]) {
#pragma unroll 1
  for (int k = 0; k < 3 * (CK / 4); ++k) {        // (dh, channel quad)
    const int dh = k / (CK / 4);
    const int q = k % (CK / 4);
    const float* const h = hs + dh * HC * CK + q * 4;
    float4 win[CW + 2];
#pragma unroll
    for (int j = 0; j < CW + 2; ++j) win[j] = load4(h + j * CK);
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 w =
            load4(ws + ((dh * 3 + dw) * CK + q * 4 + c) * COB);
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          const float4 v = win[j + dw];
          const float a = c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
          acc[j][0] = fmaf(a, w.x, acc[j][0]);
          acc[j][1] = fmaf(a, w.y, acc[j][1]);
          acc[j][2] = fmaf(a, w.z, acc[j][2]);
          acc[j][3] = fmaf(a, w.w, acc[j][3]);
        }
      }
    }
  }
}

// The block. Block index, fastest first: output depth, batch item, W tile,
// H tile, Cout tile.
template <int COB>
__global__ void __launch_bounds__(MAX_THREADS, 1)
conv3d_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                  const float* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, float* __restrict__ out,
                  const Geometry g) {
  constexpr int CG = COB / CO_T;                // channel groups
  constexpr int WF = weight_bytes(COB) / 4;     // weight floats a stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = tma_ring::smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  const float* const smem =
      reinterpret_cast<const float*>(smem_raw + (base - raw));
  const int sb = stage_bytes(COB, g.th);
  const uint32_t bars = base + g.stages * sb;   // full barriers
  // warps that have read each slot, over all its uses so far
  int* const released = reinterpret_cast<int*>(
      smem_raw + (base - raw) + g.stages * (sb + 8));

  const int D = g.R * g.P;                      // true depth
  int idx = blockIdx.x;
  const int d = idx % D; idx /= D;
  const int b = idx % g.B; idx /= g.B;
  const int x0 = (idx % g.tiles_w) * TW; idx /= g.tiles_w;
  const int y0 = (idx % g.tiles_h) * g.th; idx /= g.tiles_h;
  const int ct = idx;                           // Cout tile
  const int zs = max(d - 1, 0);                 // input planes zs .. ze
  const int ze = min(d + 1, D - 1);
  const int slices = (g.Cin + CK - 1) / CK;
  const int steps = (ze - zs + 1) * slices;
  const int t = threadIdx.x;

  // stage s (plane zs + s / slices, channels (s % slices) * CK ..) into
  // slot s % stages: the weights of its depth tap by a bulk copy, the halo
  // by TMA, both completing on the slot's full barrier
  auto load_stage = [&](int s) {
    const int slot = s % g.stages;
    const int z = zs + s / slices;
    const int sl = s % slices;
    const uint32_t full = bars + 8 * slot;
    const uint32_t dst = base + slot * sb;
    tma_ring::mbar_expect_tx(full, WF * 4 + halo_bytes(g.th));
    tma_ring::bulk_load(
        dst, w + ((static_cast<long long>(ct) * 3 + z - d + 1) * slices + sl)
                     * WF,
        WF * 4, full);
    tma_ring::tma_load_5d(dst + WF * 4, &xmap, full, sl * CK, z % g.P,
                          x0 - 1, y0 - 1, b * g.R + z / g.P);
  };
  const int warps = blockDim.x / 32;
  if (t == 0) {
    for (int s = 0; s < g.stages; ++s) {
      tma_ring::mbar_init(bars + 8 * s, 1);
      released[s] = 0;
    }
    tma_ring::mbar_fence_init();
    for (int s = 0; s < min(g.stages, steps); ++s) load_stage(s);
  }
  __syncthreads();                              // barriers initialised

  const int cg = t % CG;                        // channel group
  const int row = (t / CG) % g.th;              // output row in the tile
  const int col = t / CG / g.th * CW;           // first output column

  float acc[CW][CO_T];
#pragma unroll
  for (int j = 0; j < CW; ++j)
#pragma unroll
    for (int k = 0; k < CO_T; ++k) acc[j][k] = 0.f;

  for (int s = 0; s < steps; ++s) {
    const int slot = s % g.stages;
    tma_ring::mbar_wait(bars + 8 * slot, (s / g.stages) & 1);
    const float* const ws = smem + slot * (sb / 4);
    compute_stage<COB>(ws + WF + (row * HC + col) * CK, ws + cg * CO_T, acc);
    // this warp has read the slot (its loads returned before the products
    // that used them issued); the last warp to count out refills it with
    // step s + stages
    __syncwarp();
    if (t % 32 == 0 &&
        atomicAdd(released + slot, 1) % warps == warps - 1 &&
        s + g.stages < steps)
      load_stage(s + g.stages);
  }

  // epilogue: out = acc * scale + bias per packed channel, optional ReLU
  const int yy = y0 + row;
  if (yy >= g.H) return;
  const long long vox = static_cast<long long>(g.P) * g.Cout;
  const long long line =
      ((static_cast<long long>(b) * g.R + d / g.P) * g.H + yy) * g.W;
  const int slot = (d % g.P) * g.Cout;
  const int co = ct * COB + cg * CO_T;
  if (co >= g.Cout) return;                     // Cout % 4 == 0: all 4 or none
  const float4 s = load4(scale + slot + co);
  const float4 o = load4(bias + slot + co);
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    const int xx = x0 + col + j;
    if (xx >= g.W) break;
    float4 v;
    v.x = fmaf(acc[j][0], s.x, o.x);
    v.y = fmaf(acc[j][1], s.y, o.y);
    v.z = fmaf(acc[j][2], s.z, o.z);
    v.w = fmaf(acc[j][3], s.w, o.w);
    if (g.relu) {
      v.x = fmaxf(v.x, 0.f); v.y = fmaxf(v.y, 0.f);
      v.z = fmaxf(v.z, 0.f); v.w = fmaxf(v.w, 0.f);
    }
    store4(out + (line + xx) * vox + slot + co, v);
  }
}

// Allow the COB kernel the card's largest dynamic shared memory on the
// current device, once per device.
template <int COB>
inline cudaError_t allow_smem() {
  static int allowed[tma_ring::MAX_DEVICES];
  return tma_ring::allow_smem(conv3d_f32_kernel<COB>, MAX_SMEM, allowed);
}

template <int COB>
int launch_cob(const float* x, const float* w, const float* scale,
               const float* bias, float* out, const Geometry& g, int blocks,
               int smem, cudaStream_t stream) {
  // a plan whose shared memory is short of what the block addresses would
  // put the barriers outside the allocation
  const int nt = threads(COB, g.th);
  if (g.th < 1 || nt > MAX_THREADS || g.stages < 1 ||
      smem < smem_bytes(COB, g.th, g.stages) || smem > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const tma_ring::EncodeTiled encode = tma_ring::encode_tiled();
  if (encode == nullptr) return tma_ring::NO_ENCODE;
  // the packed volume, innermost first: channels, slot, W, H, packed rows
  // of every batch item
  const cuuint64_t ci = static_cast<cuuint64_t>(g.Cin);
  const cuuint64_t dims[5] = {ci, static_cast<cuuint64_t>(g.P),
                              static_cast<cuuint64_t>(g.W),
                              static_cast<cuuint64_t>(g.H),
                              static_cast<cuuint64_t>(g.B) * g.R};
  const cuuint64_t vox = ci * g.P * 4;          // bytes per packed voxel
  const cuuint64_t strides[4] = {ci * 4, vox, vox * g.W, vox * g.W * g.H};
  const cuuint32_t box[5] = {CK, 1, HC, static_cast<cuuint32_t>(g.th + 2),
                             1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  CUtensorMap map;
  const CUresult res = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<float*>(x), dims,
      strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return 1000 + static_cast<int>(res);
  const cudaError_t attr = allow_smem<COB>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  conv3d_f32_kernel<COB><<<blocks, nt, smem, stream>>>(map, w, scale, bias,
                                                       out, g);
  return static_cast<int>(cudaGetLastError());
}

// Launch with the plan's Cout tile cob (32 or 64). Returns the CUDA error
// code of the launch (cudaErrorInvalidValue, launching nothing, for a plan
// the block cannot take), or 999 / 1000 + the CUresult when the TMA tensor
// map cannot be made.
inline int launch(const float* x, const float* w, const float* scale,
                  const float* bias, float* out, const Geometry& g, int cob,
                  int blocks, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cob) {
    case 64: return launch_cob<64>(x, w, scale, bias, out, g, blocks, smem, s);
    case 32: return launch_cob<32>(x, w, scale, bias, out, g, blocks, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of the cob kernel resident on an SM of the current device at `th`
// rows a block and `smem` bytes of shared memory, as built (its registers
// and the shared memory bound it), or minus the CUDA error code.
inline int residency(int cob, int th, int smem) {
  int per_sm = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (cob == 64 && threads(64, th) <= MAX_THREADS) {
    err = allow_smem<64>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, conv3d_f32_kernel<64>, threads(64, th), smem);
  } else if (cob == 32 && threads(32, th) <= MAX_THREADS) {
    err = allow_smem<32>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, conv3d_f32_kernel<32>, threads(32, th), smem);
  }
  if (err == cudaSuccess) return per_sm;
  cudaGetLastError();        // reported here, not by the next launch
  return -static_cast<int>(err);
}

// Registers a thread of the cob kernel, as ptxas gave them, or minus the
// CUDA error code.
inline int registers(int cob) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cob == 64 ? cudaFuncGetAttributes(&a, conv3d_f32_kernel<64>)
      : cob == 32 ? cudaFuncGetAttributes(&a, conv3d_f32_kernel<32>)
                  : cudaErrorInvalidValue;
  return err == cudaSuccess ? a.numRegs : -static_cast<int>(err);
}

}  // namespace conv3d_tile
