// The bfloat16 3x3x3 stride-1 SAME conv3d on the D-packed layout, on
// Hopper's tensor cores, for K4 (packed_conv3d_kernel.cu): K5's block
// (conv3d_wgmma.cuh: three accumulators, each staged plane feeding the
// three output depths it touches) on a persistent grid, with an 8 x 32
// tile on four warpgroups.
//
// Function: xp [B, R, H, W, P*Ci] and the true kernel [3, 3, 3, Ci, Co]
// (passed as its shared-memory image, below), both bfloat16; products
// summed in float32 (bf16 x bf16 is exact in float32), then out = sum *
// scale + bias per packed channel (float32, [P*Co]), optional ReLU, one
// rounding to bfloat16. The packing is addressing: input depth z at packed
// row z / P, channel slot z % P.
//
// What bounds it on an H100: at the microbench's shapes (32->32 and 64->32
// at 48x96x312, 64->64 at 24x48x156) the operations take 0.080, 0.161 and
// 0.040 ms at 989 TFLOP/s (bf16 dense) and one read of x plus one write of
// y 0.055, 0.082 and 0.014 ms at 3.35 TB/s: the two are close, so both the
// products and the traffic have to be fed. A CUDA-core route tops out at
// the float32 FMA rate (67 TFLOP/s); only wgmma reaches the tensor cores.
//
// The design:
// - Implicit GEMM on wgmma.m64n32k16 (bf16 operands, float32 accumulators
//   in registers). A block owns TH = 8 output rows x TW = 32 columns x
//   N = 32 output channels; M is two output rows (64 voxels), N the Cout
//   tile, K = 27 taps x Ci in steps of 16 channels. Four consumer
//   warpgroups own two rows each: 16 warps an SM, so that one warpgroup's
//   waits (its A fragments, the ring, its epilogue) leave three to issue
//   products. The 32-column tile wastes fewer columns than one of 64 at
//   the trunk's W of 78 and 156 (96 and 160 computed, not 128 and 192)
//   and stages fewer halo columns per output.
// - A from registers (route (a)): for tap (dh, dw) the 64 rows of A are
//   halo rows 2q + dh and 2q + 1 + dh (M tile q), columns dw .. dw + 31
//   of the staged input plane, a window that starts at any voxel.
//   ldmatrix.x4 reads it from the halo
//   with per-lane addresses, so the shift is plain addressing; the halo is
//   stored with TMA's 32/64/128-byte swizzle (the width of one position's
//   CK channels), which keeps the eight 16-byte rows of each ldmatrix
//   matrix on distinct banks for any start column. One commit group per
//   (dh, dw) tap; the next tap's fragments are read into a second register
//   buffer while the group runs.
// - B, the weights, is resident in shared memory for the whole block: all
//   27 taps x Ci for the block's 32 output channels (55 KB at Ci 32, 111 KB
//   at Ci 64) in the no-swizzle K-major canonical layout (8 x 16-byte core
//   matrices), read by descriptor. The wrapper lays the kernel out in that
//   image (wgmma_weights: per call, or once for the eval trunk), so a block
//   fetches its Cout tile's weights with one bulk copy, beside its first
//   halo loads, and no thread spends instructions transposing them.
// - The halo ring: a stage is one (input plane, CK-channel slice) tile of
//   (TH + 2) x (TW + 2) positions, loaded by one TMA copy from a 5-D tensor
//   map over the packed volume [B, R, H, W, P*Ci] with the box [CK, 34, 10,
//   1, 1] at (slot * Ci + c0, w0 - 1, h0 - 1, row, b). Out-of-bounds box
//   elements are zero-filled, which is the SAME halo at every H / W border,
//   with no padded copy. Planes outside the volume are never loaded (their
//   taps are skipped). The ring holds 2-4 stages, guarded by full (TMA
//   transaction bytes) and empty (all 512 threads) mbarriers; thread 0
//   issues the first stages beside the weights' copy and refills a slot
//   as soon as it has been read, so loads run while the products of
//   the earlier stages run. There is no producer warp: 16 warps of 128
//   registers fill the SM's register file.
// - The walk: a block owns one Cout tile and walks runs of consecutive
//   output depths d0 .. d1 - 1 of one 8 x 32 tile; it stages each input
//   plane z = d0 - 1 .. d1 of a run once, and each staged plane feeds three
//   accumulators, for outputs z - 1, z and z + 1 (depth taps 2, 1 and 0),
//   the A fragments loaded once for all three. When plane z is consumed,
//   output z - 1 goes through the epilogue. A run's two halo planes run
//   only the one tap that feeds it.
// - Which runs (the launch plan, ops/cuda/packed_conv3d_kernel.py::
//   wgmma_plan): the output of a Cout tile is numbered in work items of one
//   depth of one tile, depth fastest, then batch, W tile, H tile. K4 is a
//   persistent grid: about one block per SM for each Cout tile, block j
//   walking items [j * items / per_tile, (j + 1) * items / per_tile), so
//   that its weights are fetched once and its halo planes are shared by up
//   to items / per_tile outputs (a block for each work item of one depth,
//   K4's first layout, spent most of its time fetching 110 KB of weights
//   and three planes of halo to compute one output depth: 14 waves of such
//   blocks at 24x48x156). The ring keeps counting across runs: thread 0's
//   load cursor runs `stages` steps ahead of the products, into the next
//   run, so the next run's first planes load while this run's last taps and
//   its epilogue run.
// - Epilogue from the accumulator fragments: scale and bias of packed
//   channel (d % P) * Co + c in float32, optional ReLU, two channels
//   rounded to one bf16x2 store, masked at the ragged H, W and Co edges.
// Needs Ci % 16 == 0 (k16 steps), Co % 8 == 0 (core-matrix rows and
// output pairs) and the weights plus two stages within the 227 KB of
// shared memory (Ci <= 112); the caller checks.

#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tma_ring.cuh"

namespace conv3d_wgmma_persistent {
// Internal linkage: this library holds its own copy of everything here,
// per-device tables included (a function-local static of a template with
// external linkage is one object across every library the process loads,
// so another library's table could answer for this kernel).
namespace {

using tma_ring::bulk_load;
using tma_ring::encode_tiled;
using tma_ring::EncodeTiled;
using tma_ring::mbar_arrive;
using tma_ring::mbar_expect_tx;
using tma_ring::mbar_init;
using tma_ring::mbar_wait;
using tma_ring::NO_ENCODE;
using tma_ring::smem_u32;
using tma_ring::tma_load_5d;

constexpr int TH = 8;               // output rows per block
constexpr int TW = 32;              // output columns per block
constexpr int N = 32;               // output channels per block (wgmma N)
constexpr int HR = TH + 2;          // halo rows
constexpr int HC = TW + 2;          // halo columns
constexpr int THREADS = 512;        // four warpgroups
constexpr int MT = TH * TW / 64 / (THREADS / 128);  // M tiles a warpgroup
constexpr int ALIGN = 1024;         // stage alignment (128-byte swizzle)
constexpr int MAX_SMEM = 232448;    // dynamic shared memory a block may have
// One B slab: 16 input channels of one tap for the N output channels, as
// N / 8 x 2 core matrices of 8 rows x 16 bytes: K-direction (LBO) and
// N-direction (SBO) byte strides between core matrices.
constexpr int LBO = 128;
constexpr int SBO = 256;
constexpr int SLAB = N * 16 * 2;

// The launch geometry, as the wrapper's plan computed it: per_tile blocks
// for each Cout tile (set by launch), each with a share of its work items.
struct Geometry {
  int B, R, P, H, W, Ci, Co, relu;
  int per_tile, tiles_h, tiles_w, stages;
};

// A run of output depths d0 .. d1 - 1 of one tile (batch item b, first
// column x0, first row y0), and the input planes zs .. ze it reads.
struct Run {
  int b, x0, y0, d0, d1, zs, ze;
};

// The run that starts at work item i of a block whose items end at hi;
// items are numbered depth fastest, then batch item, W tile, H tile.
__device__ __forceinline__ Run run_at(const Geometry& g, int i, int hi) {
  const int D = g.R * g.P;
  int t = i / D;
  Run u;
  u.d0 = i - t * D;
  u.d1 = min(D, u.d0 + (hi - i));
  u.b = t % g.B;
  t /= g.B;
  u.x0 = (t % g.tiles_w) * TW;
  u.y0 = (t / g.tiles_w) * TH;
  u.zs = max(u.d0 - 1, 0);
  u.ze = min(u.d1, D - 1);
  return u;
}

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// The block's dynamic shared memory, in this order from the first ALIGN
// boundary: the weights (27 * Ci x N bf16), then `stages` halo tiles of
// (HR x HC x CK) bf16, each ALIGN aligned, then the full and empty barriers
// of each stage and the weights' barrier. The kernel addresses it through
// these; smem_bytes adds ALIGN bytes of slack for the first boundary.
__host__ __device__ constexpr int weight_bytes(int ci) {
  return round_up(27 * ci * N * 2, ALIGN);
}
__host__ __device__ constexpr int stage_bytes(int ck) {
  return round_up(HR * HC * ck * 2, ALIGN);
}
__host__ __device__ constexpr int smem_bytes(int ci, int ck, int stages) {
  return ALIGN + weight_bytes(ci) + stages * stage_bytes(ck) +
         16 * stages + 8;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// Descriptor of a B slab at shared address `addr`: no swizzle, K-major.
__device__ __forceinline__ uint64_t slab_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(LBO >> 4) << 16) |
         (static_cast<uint64_t>(SBO >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most `pending` commit groups are still running.
template <int pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(pending)
               : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (registers, 64 x 16 bf16) * B (slab descriptor, 16 x 32 bf16).
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Epilogue of output depth od from the accumulators a of M tile q (rows
// 2 q and 2 q + 1 of the block): fragment element (A row g or g + 8,
// column 8j + 2t, +1) of d[4j ..] for g = warp * 16 + lane / 4, t = lane %
// 4; A row m is block row 2 q + m / 32, column m % 32.
__device__ __forceinline__ void store_depth(
    float (&a)[16], __nv_bfloat16* __restrict__ out,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const Geometry& g, int b, int od, int y0, int x0, int co0, int q,
    int warp, int lane) {
  const long long vox = static_cast<long long>(g.P) * g.Co;
  const long long plane = (static_cast<long long>(b) * g.R + od / g.P) * g.H;
  const int slot = (od % g.P) * g.Co;
  const int yy = y0 + q * 2 + warp / 2;
  if (yy >= g.H) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int xx = x0 + (warp % 2) * 16 + (lane >> 2) + 8 * h;
    if (xx >= g.W) continue;
    __nv_bfloat16* const o = out + ((plane + yy) * g.W + xx) * vox + slot;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int co = co0 + 8 * j + 2 * (lane & 3);
      if (co >= g.Co) continue;               // Co % 8 == 0: both or none
      float v0 = fmaf(a[4 * j + 2 * h], scale[slot + co], bias[slot + co]);
      float v1 = fmaf(a[4 * j + 2 * h + 1], scale[slot + co + 1],
                      bias[slot + co + 1]);
      if (g.relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      *reinterpret_cast<__nv_bfloat162*>(o + co) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// The block: Cout tile blockIdx.x / per_tile, and its share
// blockIdx.x % per_tile of that tile's work items, walked as
// runs of consecutive output depths of one tile.
template <int CK>
__global__ void __launch_bounds__(THREADS, 1)
conv3d_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, const Geometry g) {
  static_assert(CK == 16 || CK == 32 || CK == 64, "CK: 16, 32 or 64");
  constexpr int STAGE = HR * HC * CK * 2;           // bytes of one stage
  constexpr int STRIDE = stage_bytes(CK);
  constexpr int KS = CK / 16;                       // k16 steps per stage
  constexpr int SWZ = CK / 8 - 1;                   // swizzle row mask

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t wsm = (raw + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  const int ci16 = g.Ci / 16;                       // slabs per tap
  const uint32_t halo = wsm + weight_bytes(g.Ci);
  // full barriers, then empty ones, then the weights'
  const uint32_t bars = halo + g.stages * STRIDE;

  const int co0 = blockIdx.x / g.per_tile * N;
  const int share = blockIdx.x % g.per_tile;
  const int D = g.R * g.P;
  // the block's items: a balanced contiguous share
  const long long items =
      static_cast<long long>(D) * g.B * g.tiles_w * g.tiles_h;
  const int lo = static_cast<int>(share * items / g.per_tile);
  const int hi = static_cast<int>((share + 1) * items / g.per_tile);
  const int slices = g.Ci / CK;
  const int t = threadIdx.x;

  // thread 0 keeps the ring full: the first stages now, beside the
  // weights' copy, each later one as soon as every thread has read the
  // stage `stages` before it. Its cursor: slice psl of plane pz of the run
  // that starts at item pi, and the loads issued; the cursor crosses from
  // one run into the next, so the ring never drains between runs.
  int pi = lo, pz = run_at(g, lo, hi).zs, psl = 0, issued = 0;
  auto load_next = [&]() {
    const Run u = run_at(g, pi, hi);
    const int slot = issued % g.stages;
    mbar_expect_tx(bars + 8 * slot, STAGE);
    tma_load_5d(halo + slot * STRIDE, &xmap, bars + 8 * slot,
                (pz % g.P) * g.Ci + psl * CK, u.x0 - 1, u.y0 - 1, pz / g.P,
                u.b);
    ++issued;
    if (++psl == slices) {
      psl = 0;
      if (++pz > u.ze) {
        pi += u.d1 - u.d0;
        if (pi < hi) pz = run_at(g, pi, hi).zs;
      }
    }
  };
  const uint32_t wbar = bars + 16 * g.stages;       // the weights' barrier
  const int wbytes = 27 * g.Ci * N * 2;
  if (t == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (g.stages + s), THREADS);
    }
    mbar_init(wbar, 1);
    tma_ring::mbar_fence_init();
    // the block's Cout tile of the weight image, one bulk copy, once
    mbar_expect_tx(wbar, wbytes);
    bulk_load(wsm, w + static_cast<long long>(co0 / N) * (wbytes / 2),
              wbytes, wbar);
    for (int s = 0; s < g.stages && pi < hi; ++s) load_next();
  }
  __syncthreads();                                  // barriers initialised

  // warpgroup wg owns M tiles wg * MT .. wg * MT + MT - 1; M tile q is
  // block rows 2 q and 2 q + 1
  const int wg = t / 128;
  const int warp = (t / 32) % 4;
  const int lane = t % 32;
  // this lane's ldmatrix row (A row m: block row 2 q + m / 32, column
  // m % 32) and 16-byte half of a k16 step
  const int m = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int half = lane >> 4;
  const int arow = wg * MT * 2 + m / 32, acol = m % 32;

  // acc[j][r] sums output z - 1 + j of M tile wg * MT + r while plane z
  // is consumed
  float acc[3][MT][16];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[j][r][i] = 0.f;

  mbar_wait(wbar, 0);
  int s = 0;                                        // steps consumed
  for (int i = lo; i < hi;) {
    const Run u = run_at(g, i, hi);
    for (int z = u.zs; z <= u.ze; ++z) {
      // depth tap feeding each accumulator from plane z (-1: none);
      // uniform over the block
      int dd[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int o = z - 1 + j;
        dd[j] = (o >= u.d0 && o < u.d1) ? 2 - j : -1;
      }
      for (int sl = 0; sl < slices; ++sl, ++s) {
        // step s - 1's slot is free once all threads have read it: refill
        // it with the cursor's step, s - 1 + stages (testing for it between
        // taps instead, so that thread 0's warpgroup need not wait for the
        // others, ran slower on the card)
        if (t == 0 && s > 0 && pi < hi) {
          mbar_wait(bars + 8 * (g.stages + (s - 1) % g.stages),
                    ((s - 1) / g.stages) & 1);
          load_next();
        }
        const int slot = s % g.stages;
        mbar_wait(bars + 8 * slot, (s / g.stages) & 1);
        const uint32_t hs = halo + slot * STRIDE;
        // the A fragments of tap `tap`, all M tiles and k16 steps of the
        // stage
        auto load_a = [&](uint32_t (&a)[KS][MT][4], int tap) {
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
#pragma unroll
            for (int r = 0; r < MT; ++r) {
              const int pos = (arow + 2 * r + tap / 3) * HC + acol + tap % 3;
              uint32_t off = pos * (CK * 2) + (2 * ks + half) * 16;
              off ^= ((off >> 7) & SWZ) << 4;         // TMA's swizzle
              ldmatrix_x4(a[ks][r], hs + off);
            }
        };
        // one commit group per (dh, dw) tap; the next tap's fragments are
        // read into the other buffer while this tap's products run
        uint32_t a[2][KS][MT][4];
        load_a(a[0], 0);
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            if (dd[j] < 0) continue;
            const uint32_t slab0 =
                wsm + ((dd[j] * 9 + tap) * ci16 + sl * KS) * SLAB;
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
              const uint64_t desc = slab_desc(slab0 + ks * SLAB);
#pragma unroll
              for (int r = 0; r < MT; ++r)
                wgmma_m64n32k16(acc[j][r], a[tap % 2][ks][r], desc);
            }
          }
          wgmma_commit();
          if (tap < 8) {
            wgmma_wait<1>();      // tap - 1's group, the other buffer's reader
            load_a(a[(tap + 1) % 2], tap + 1);
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int r = 0; r < MT; ++r) fence_acc(acc[j][r]);
        mbar_arrive(bars + 8 * (g.stages + slot));  // stage read
      }
      // plane z consumed: output z - 1 is complete
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        if (z - 1 >= u.d0)
          store_depth(acc[0][r], out, scale, bias, g, u.b, z - 1, u.y0, u.x0,
                      co0, wg * MT + r, warp, lane);
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          acc[0][r][k] = acc[1][r][k];
          acc[1][r][k] = acc[2][r][k];
          acc[2][r][k] = 0.f;
        }
      }
    }
    // the run's last plane was D - 1 < d1: output D - 1 (now in acc[0])
    // had no plane after it
    if (u.ze < u.d1) {
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        store_depth(acc[0][r], out, scale, bias, g, u.b, u.ze, u.y0, u.x0,
                    co0, wg * MT + r, warp, lane);
#pragma unroll
        for (int k = 0; k < 16; ++k) acc[0][r][k] = 0.f;
      }
    }
    i += u.d1 - u.d0;
  }
}

template <int CK>
int launch_ck(const __nv_bfloat16* x, const __nv_bfloat16* w,
              const float* scale, const float* bias, __nv_bfloat16* out,
              const Geometry& g, int blocks, int smem, cudaStream_t stream) {
  // a plan whose shared memory is short of what the block addresses would
  // put the barriers outside the allocation
  if (g.Ci % CK != 0 || g.stages < 1 || smem < smem_bytes(g.Ci, CK, g.stages)
      || smem > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return NO_ENCODE;
  // the packed volume, innermost first: channels, W, H, packed rows, batch
  const cuuint64_t vox = static_cast<cuuint64_t>(g.P) * g.Ci;
  const cuuint64_t dims[5] = {vox, static_cast<cuuint64_t>(g.W),
                              static_cast<cuuint64_t>(g.H),
                              static_cast<cuuint64_t>(g.R),
                              static_cast<cuuint64_t>(g.B)};
  const cuuint64_t strides[4] = {vox * 2, vox * 2 * g.W, vox * 2 * g.W * g.H,
                                 vox * 2 * g.W * g.H * g.R};
  const cuuint32_t box[5] = {CK, HC, HR, 1, 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      CK == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
               : (CK == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B);
  CUtensorMap map;
  const CUresult res = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
      const_cast<__nv_bfloat16*>(x), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return 1000 + static_cast<int>(res);
  static int allowed[tma_ring::MAX_DEVICES];
  const cudaError_t attr =
      tma_ring::allow_smem(conv3d_wgmma_kernel<CK>, MAX_SMEM, allowed);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  conv3d_wgmma_kernel<CK><<<blocks, THREADS, smem, stream>>>(
      map, w, scale, bias, out, g);
  return static_cast<int>(cudaGetLastError());
}

// The launch's ints, as the wrapper packs them once per call shape
// (ops/cuda/packed_conv3d_kernel.py::wgmma_dims): the shapes, ReLU, then
// the plan.
enum Dim {
  D_B, D_R, D_P, D_H, D_W, D_CI, D_CO, D_RELU,
  D_CK, D_STAGES, D_TILES_H, D_TILES_W, D_BLOCKS, D_SMEM, D_COUNT
};

// Launch on `d` (Dim): channel slice ck (16, 32 or 64), blocks / Cout
// tiles blocks for each Cout tile (a grid that is not a multiple of the
// Cout tiles, or has more blocks for a tile than it has work items,
// launches nothing: cudaErrorInvalidValue).
inline int launch(const __nv_bfloat16* x, const __nv_bfloat16* w,
                  const float* scale, const float* bias, __nv_bfloat16* out,
                  const int* d, void* stream) {
  Geometry g{d[D_B], d[D_R], d[D_P], d[D_H], d[D_W], d[D_CI], d[D_CO],
             d[D_RELU], 0, d[D_TILES_H], d[D_TILES_W], d[D_STAGES]};
  const int blocks = d[D_BLOCKS], smem = d[D_SMEM];
  const int cout_tiles = (g.Co + N - 1) / N;
  const long long items =
      static_cast<long long>(g.R) * g.P * g.B * g.tiles_w * g.tiles_h;
  if (blocks < cout_tiles || blocks % cout_tiles != 0 ||
      blocks / cout_tiles > items)
    return static_cast<int>(cudaErrorInvalidValue);
  g.per_tile = blocks / cout_tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d[D_CK]) {
    case 64: return launch_ck<64>(x, w, scale, bias, out, g, blocks, smem, s);
    case 32: return launch_ck<32>(x, w, scale, bias, out, g, blocks, smem, s);
    case 16: return launch_ck<16>(x, w, scale, bias, out, g, blocks, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers a thread of the block with channel slice ck, as ptxas gave
// them; minus the CUDA error code when they cannot be read.
inline int registers(int ck) {
  cudaFuncAttributes a;
  cudaError_t err = cudaErrorInvalidValue;
  switch (ck) {
    case 64: err = cudaFuncGetAttributes(&a, conv3d_wgmma_kernel<64>);
      break;
    case 32: err = cudaFuncGetAttributes(&a, conv3d_wgmma_kernel<32>);
      break;
    case 16: err = cudaFuncGetAttributes(&a, conv3d_wgmma_kernel<16>);
      break;
  }
  return err == cudaSuccess ? a.numRegs : -static_cast<int>(err);
}

}  // namespace
}  // namespace conv3d_wgmma_persistent
