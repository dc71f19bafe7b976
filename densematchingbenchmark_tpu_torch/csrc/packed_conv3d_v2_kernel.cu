// K5: 3x3x3 stride-1 SAME conv3d on the D-packed volume layout with a fused
// per-packed-channel scale/bias (+ReLU) epilogue, walking depth inside the
// block: float32 in and out on the CUDA cores (packed_conv3d_v2_f32, the
// kernel below), or bfloat16 operands and output on the tensor cores with
// float32 sums and epilogue (packed_conv3d_v2_bf16: the wgmma block of
// conv3d_wgmma.cuh in K5's order, three accumulators fed by each plane of
// a depth chunk staged once through the TMA ring; that header says what
// bounds it and how the design meets it).
//
// Replaces the TPU kernel densematchingbenchmark_tpu/ops/pallas/
// packed_conv3d_kernel.py::conv3d_packed_s1_pallas_v2 (body _kernel_v2,
// launched from _forward_v2): K4's function, forward only. The TPU kernel
// grids over (batch, H tile) and streams the packed depth rows of its tile
// through a 4-slot VMEM ring, prefetching the next row while one computes,
// so each row is read once per H tile instead of three times.
//
// The counterpart here: a block owns a 4 x 32 (rows x columns) output tile,
// 32 output channels and a chunk of dc consecutive output depths d0 ..
// d1 - 1 of one batch item, and walks the input depth planes z = d0 - 1 ..
// d1 in order. Each input plane, with its H / W halo, is staged in shared
// memory once and feeds the three outputs it touches: z + 1 (depth tap 0),
// z (tap 1) and z - 1 (tap 2), whose sums stay in registers. When plane z
// has been consumed, output z - 1 is complete and goes through the
// epilogue. K4, by contrast, stages each input plane once per output depth
// tap (three times). The packing is addressing, as in K4: input depth z at
// packed row z / P, slot z % P.
//
// What bounds the float32 route on an H100: arithmetic, 2*27*Cin*Cout flops
// per output voxel on the CUDA cores (67 TFLOP/s float32; TF32 is outside
// the float32 contract), 4.15 ms for the packed-conv microbench's three
// cases. Each FMA needs its input and its weight from shared memory, so
// what decides how close a block comes is how few instructions it issues
// beside the FMAs and how well its warps hide the shared-memory loads.
//
// The design (redesigned from a 128-thread block whose threads computed
// cp.async addresses and masks for the staging):
// - The ring is fed by the Tensor Memory Accelerator, as the bf16 block's
//   (conv3d_wgmma.cuh): a stage is one (input plane, 16-channel slice)
//   pair, its (4+2) x (32+2) x 16 halo loaded by one TMA copy from a 5-D
//   tensor map over the packed volume seen as [B*R, H, W, P, Cin], box
//   [16, 1, 34, 6, 1], and its 27 x 16 x 32 weights by one bulk copy of the
//   wrapper's image (packed_v2_weights: [Cout tiles, Cin slices, 27, 16,
//   32], zero past Cin and Cout). Out-of-bounds box elements are
//   zero-filled, which is the SAME halo at every H / W border and zeroes
//   the channels past Cin of a ragged last slice: they are never read from
//   the next packed slot. Three stages (68.4 KB each) are guarded by full
//   (transaction bytes) and empty (all threads) mbarriers, and thread 0
//   refills a slot as soon as every thread has read it, so no thread
//   computes an address or a mask for the staging.
// - A thread sums 4 rows x 4 output channels x 3 output depths (48
//   accumulators); a block has 256 threads (32 columns x 8 channel groups,
//   the channel group fastest, so that a warp's weight loads are one
//   128-byte row and its input loads four broadcast positions). Per tap a
//   thread issues 64 16-byte shared loads for 768 FMAs. The block may take
//   up to 255 registers (ptxas gives it 152) and one block runs on an SM:
//   the same tile capped at 128 registers, two blocks and 16 warps an SM,
//   ran slower on the card, as did 8-channel stages.
// - The depth chunk, as before: the two halo planes of a chunk run only
//   the one depth tap that feeds it (a compile-time variant of the stage),
//   so a chunk does the products of 3 * dc + 2 taps for 3 * dc. The
//   launcher picks dc from 16, 12, 8, 6, 4 to minimise waves x (3 * dc +
//   2), a wave being the blocks resident on the card at once, read from the
//   built kernel (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// Needs Cin % 4 == 0 and Cout % 4 == 0 (TMA's 16-byte strides, 16-byte
// epilogue stores); ragged H, W, D, Cin and Cout edges are masked.

#include "conv3d_tile.cuh"
#include "conv3d_wgmma.cuh"
#include "tma_ring.cuh"

namespace {

using conv3d_tile::load4;
using conv3d_tile::store4;
namespace ring = tma_ring;

constexpr int TH = 4;            // output rows per block and per thread
constexpr int TW = 32;           // output columns per block
constexpr int CO_B = 32;         // output channels per block
constexpr int CO_T = 4;          // output channels per thread
constexpr int NT = 256;          // threads: 32 columns x 8 channel groups
constexpr int CK = 16;           // input channels per stage
constexpr int HR = TH + 2;       // halo rows
constexpr int HC = TW + 2;       // halo columns
constexpr int HALO_BYTES = HR * HC * CK * 4;       // 13,056
constexpr int W_FLOATS = 27 * CK * CO_B;           // one slice's weights
constexpr int W_BYTES = W_FLOATS * 4;              // 55,296
constexpr int STAGE_BYTES = HALO_BYTES + W_BYTES;  // 68,352
constexpr int STAGES = 3;
constexpr int ALIGN = 128;       // TMA destination alignment
// the stages, then a full and an empty barrier per stage
constexpr int SMEM_BYTES = ALIGN + STAGES * STAGE_BYTES + 16 * STAGES;
static_assert(STAGE_BYTES % ALIGN == 0 && HALO_BYTES % 16 == 0,
              "stage layout");

// Epilogue of one output depth d's sums a (this thread's column xx, rows
// y0 .., channels co ..): out = a * scale + bias per packed channel,
// optional ReLU.
__device__ __forceinline__ void store_depth(
    const float (&a)[TH][CO_T], float* __restrict__ out,
    const float* __restrict__ scale, const float* __restrict__ bias, int d,
    int b, int R, int P, int H, int W, int Cout, int y0, int xx, int co,
    int relu) {
  if (xx >= W || co >= Cout) return;       // Cout % 4 == 0: all 4 or none
  const long long out_vox = (long long)P * Cout;
  const long long out_plane = ((long long)b * R + d / P) * H;
  const int slot = (d % P) * Cout;
  const float4 s = load4(scale + slot + co);
  const float4 o = load4(bias + slot + co);
#pragma unroll
  for (int i = 0; i < TH; ++i) {
    const int yy = y0 + i;
    if (yy >= H) break;
    float4 v;
    v.x = fmaf(a[i][0], s.x, o.x);
    v.y = fmaf(a[i][1], s.y, o.y);
    v.z = fmaf(a[i][2], s.z, o.z);
    v.w = fmaf(a[i][3], s.w, o.w);
    if (relu) {
      v.x = fmaxf(v.x, 0.f); v.y = fmaxf(v.y, 0.f);
      v.z = fmaxf(v.z, 0.f); v.w = fmaxf(v.w, 0.f);
    }
    store4(out + ((out_plane + yy) * W + xx) * out_vox + slot + co, v);
  }
}

// One stage's products: the staged halo hs and weights ws (one 16-channel
// slice of input plane z) into acc[j], the sums of output z - 1 + j; input
// plane z, depth tap dd feeds output z + 1 - dd = acc[2 - dd]. ONLY >= 0
// does depth tap ONLY alone (a halo plane of the chunk, whose other taps
// feed outputs outside it); a compile-time choice, so the unrolled FMAs
// carry no branch.
template <int ONLY>
__device__ __forceinline__ void compute_stage(const float* __restrict__ hs,
                                              const float* __restrict__ ws,
                                              float (&acc)[3][TH][CO_T],
                                              int vx, int cg) {
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dh = tap / 3;
    const int dw = tap % 3;
    float a[TH][CK];
#pragma unroll
    for (int i = 0; i < TH; ++i)
#pragma unroll
      for (int q = 0; q < CK / 4; ++q) {
        const float4 v = load4(hs + ((i + dh) * HC + vx + dw) * CK + 4 * q);
        a[i][4 * q] = v.x;
        a[i][4 * q + 1] = v.y;
        a[i][4 * q + 2] = v.z;
        a[i][4 * q + 3] = v.w;
      }
#pragma unroll
    for (int c = 0; c < CK; ++c) {
#pragma unroll
      for (int dd = 0; dd < 3; ++dd) {
        if (ONLY >= 0 && dd != ONLY) continue;
        const float4 wv =
            load4(ws + ((dd * 9 + tap) * CK + c) * CO_B + cg * CO_T);
#pragma unroll
        for (int i = 0; i < TH; ++i) {
          float (&o)[CO_T] = acc[2 - dd][i];
          o[0] = fmaf(a[i][c], wv.x, o[0]);
          o[1] = fmaf(a[i][c], wv.y, o[1]);
          o[2] = fmaf(a[i][c], wv.z, o[2]);
          o[3] = fmaf(a[i][c], wv.w, o[3]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(NT, 1)
packed_conv3d_v2_kernel(const __grid_constant__ CUtensorMap xmap,
                        const float* __restrict__ w,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        float* __restrict__ out,
                        int R, int P, int H, int W, int Cin, int Cout,
                        int relu, int dc, int chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = ring::smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  const float* const smem =
      reinterpret_cast<const float*>(smem_raw + (base - raw));
  // full barriers, then empty ones
  const uint32_t bars = base + STAGES * STAGE_BYTES;

  const int D = R * P;                          // true depth
  const int t = threadIdx.x;
  const int cg = t & 7;                         // channel group: CO_T channels
  const int vx = t >> 3;                        // output column in the tile
  const int tiles_w = (W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int b = blockIdx.y / chunks;
  const int d0 = (blockIdx.y % chunks) * dc;    // outputs d0 .. d1 - 1
  const int d1 = min(d0 + dc, D);
  const int co0 = blockIdx.z * CO_B;
  const int zs = max(d0 - 1, 0);                // input planes zs .. ze
  const int ze = min(d1, D - 1);
  const int slices = (Cin + CK - 1) / CK;
  const int steps = (ze - zs + 1) * slices;

  // stage s (plane zs + s / slices, channels (s % slices) * CK ..) into
  // slot s % STAGES: the halo by TMA, the slice's weights by a bulk copy,
  // both completing on the slot's full barrier
  auto load_stage = [&](int s) {
    const int slot = s % STAGES;
    const int z = zs + s / slices;
    const int sl = s % slices;
    const uint32_t full = bars + 8 * slot;
    const uint32_t dst = base + slot * STAGE_BYTES;
    ring::mbar_expect_tx(full, STAGE_BYTES);
    ring::tma_load_5d(dst, &xmap, full, sl * CK, z % P, x0 - 1, y0 - 1,
                    b * R + z / P);
    ring::bulk_load(dst + HALO_BYTES,
                  w + ((long long)blockIdx.z * slices + sl) * W_FLOATS,
                  W_BYTES, full);
  };
  if (t == 0) {
    for (int s = 0; s < STAGES; ++s) {
      ring::mbar_init(bars + 8 * s, 1);
      ring::mbar_init(bars + 8 * (STAGES + s), NT);
    }
    ring::mbar_fence_init();
    for (int s = 0; s < min(STAGES, steps); ++s) load_stage(s);
  }
  __syncthreads();                              // barriers initialised

  // acc[j] sums output depth z - 1 + j while plane z is consumed
  float acc[3][TH][CO_T];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < TH; ++i)
#pragma unroll
      for (int k = 0; k < CO_T; ++k) acc[j][i][k] = 0.f;

  for (int s = 0; s < steps; ++s) {
    // step s - 1's slot is free once every thread has read it: refill it
    // with step s - 1 + STAGES
    if (t == 0 && s > 0 && s - 1 + STAGES < steps) {
      ring::mbar_wait(bars + 8 * (STAGES + (s - 1) % STAGES),
                    ((s - 1) / STAGES) & 1);
      load_stage(s - 1 + STAGES);
    }
    const int slot = s % STAGES;
    ring::mbar_wait(bars + 8 * slot, (s / STAGES) & 1);
    const float* const hs = smem + slot * (STAGE_BYTES / 4);
    const float* const ws = hs + HALO_BYTES / 4;
    const int z = zs + s / slices;
    // the halo planes d0 - 1 and d1 feed one output of the chunk each;
    // planes d0 and d1 - 1 feed one output outside it, whose sums are
    // never stored
    if (z == d0 - 1)
      compute_stage<0>(hs, ws, acc, vx, cg);
    else if (z == d1)
      compute_stage<2>(hs, ws, acc, vx, cg);
    else
      compute_stage<-1>(hs, ws, acc, vx, cg);
    ring::mbar_arrive(bars + 8 * (STAGES + slot));  // stage read
    if (s % slices == slices - 1) {
      // plane z consumed: output z - 1 is complete
      if (z - 1 >= d0)
        store_depth(acc[0], out, scale, bias, z - 1, b, R, P, H, W, Cout, y0,
                    x0 + vx, co0 + cg * CO_T, relu);
#pragma unroll
      for (int i = 0; i < TH; ++i)
#pragma unroll
        for (int k = 0; k < CO_T; ++k) {
          acc[0][i][k] = acc[1][i][k];
          acc[1][i][k] = acc[2][i][k];
          acc[2][i][k] = 0.f;
        }
    }
  }
  // plane d1 lies past the volume: output d1 - 1 is complete in acc[0]
  if (ze == d1 - 1)
    store_depth(acc[0], out, scale, bias, d1 - 1, b, R, P, H, W, Cout, y0,
                x0 + vx, co0 + cg * CO_T, relu);
}

// Output depths per block: the chunk, of DCS, that minimises waves x taps
// per block, where a wave is `slots` resident blocks and a chunk of dc
// depths runs the products of 3 * dc + 2 depth taps (its two halo planes
// one tap each); on a tie the larger chunk, which stages less halo.
constexpr int DCS[] = {16, 12, 8, 6, 4};

inline int depth_chunk(int D, long long tiles, int slots) {
  int best = DCS[0];
  long long best_cost = -1;
  for (int dc : DCS) {
    const long long blocks = tiles * ((D + dc - 1) / dc);
    const long long cost =
        (blocks + slots - 1) / slots * (3LL * (dc < D ? dc : D) + 2);
    if (best_cost < 0 || cost < best_cost) {
      best = dc;
      best_cost = cost;
    }
  }
  return best;
}

// Resident blocks on the current device: SMs x blocks per SM (the built
// kernel's registers and the shared memory bound it), read once per device
// after the kernel's shared-memory limit is set there.
inline int resident_blocks() {
  static int slots[ring::MAX_DEVICES];
  const int dev = ring::current_device();
  const bool kept = dev >= 0 && dev < ring::MAX_DEVICES;
  if (kept && slots[dev] > 0) return slots[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, packed_conv3d_v2_kernel, NT, SMEM_BYTES);
  const int n = sms * per_sm > 0 ? sms * per_sm : 1;
  if (kept) slots[dev] = n;
  return n;
}

}  // namespace

// xp [B, R, H, W, P*Cin] and out [B, R, H, W, P*Cout] float32; w the
// wrapper's image of the kernel (ops/cuda/packed_conv3d_kernel.py::
// packed_v2_weights: [ceil(Cout / 32), ceil(Cin / 16), 27, 16, 32]
// float32); scale / bias [P*Cout] float32; all contiguous, 16-byte aligned,
// with Cin % 4 == 0, Cout % 4 == 0 and B * R * P <= 65535 (checked by the
// caller). Returns the CUDA error code of the launch (0 on success), or
// 999 / 1000 + the CUresult when the TMA tensor map cannot be made.
extern "C" int packed_conv3d_v2_f32(const float* x, const float* w,
                                    const float* scale, const float* bias,
                                    float* out, int B, int R, int P, int H,
                                    int W, int Cin, int Cout, int relu,
                                    void* stream) {
  const ring::EncodeTiled encode = ring::encode_tiled();
  if (encode == nullptr) return ring::NO_ENCODE;
  // the packed volume, innermost first: channels, slot, W, H, packed rows
  // of every batch item
  const cuuint64_t ci = static_cast<cuuint64_t>(Cin);
  const cuuint64_t dims[5] = {ci, static_cast<cuuint64_t>(P),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B) * R};
  const cuuint64_t vox = ci * P * 4;            // bytes per packed voxel
  const cuuint64_t strides[4] = {ci * 4, vox, vox * W, vox * W * H};
  const cuuint32_t box[5] = {CK, 1, HC, HR, 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  CUtensorMap map;
  const CUresult res = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<float*>(x), dims,
      strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return 1000 + static_cast<int>(res);
  static int allowed[ring::MAX_DEVICES];
  const cudaError_t attr =
      ring::allow_smem(packed_conv3d_v2_kernel, SMEM_BYTES, allowed);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int slots = resident_blocks();
  const int D = R * P;
  const long long tiles = (long long)((H + TH - 1) / TH) *
                          ((W + TW - 1) / TW) * ((Cout + CO_B - 1) / CO_B) *
                          B;
  const int dc = depth_chunk(D, tiles, slots);
  const int chunks = (D + dc - 1) / dc;
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), B * chunks,
                  (Cout + CO_B - 1) / CO_B);
  packed_conv3d_v2_kernel<<<grid, NT, SMEM_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(
      map, w, scale, bias, out, R, P, H, W, Cin, Cout, relu, dc, chunks);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread and resident blocks an SM of the float32 kernel, as
// built (residency from cudaOccupancyMaxActiveBlocksPerMultiprocessor with
// its shared memory): regs * 1000 + blocks, or minus the CUDA error code.
extern "C" int packed_conv3d_v2_f32_residency() {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, packed_conv3d_v2_kernel);
  if (err != cudaSuccess) return -static_cast<int>(err);
  err = cudaFuncSetAttribute(packed_conv3d_v2_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, packed_conv3d_v2_kernel, NT, SMEM_BYTES);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return a.numRegs * 1000 + per_sm;
}

// The same function in bfloat16 (x, out, and w as the wrapper's
// shared-memory image of the kernel, ops/cuda/packed_conv3d_kernel.py::
// wgmma_weights), on the tensor cores, with the caller's launch plan:
// channel slice ck, ring stages, depth chunk dc and chunks, tiles, blocks
// and dynamic shared memory bytes. Needs Cin % 16 == 0, Cout % 8 == 0 and
// 16-byte aligned operands (checked by the caller).
// Returns the CUDA error code of the launch (cudaErrorInvalidValue,
// launching nothing, when smem is short of the block's layout), or 999 /
// 1000 + the CUresult when the TMA tensor map cannot be made.
extern "C" int packed_conv3d_v2_bf16(const __nv_bfloat16* x,
                                     const __nv_bfloat16* w,
                                     const float* scale, const float* bias,
                                     __nv_bfloat16* out, int B, int R, int P,
                                     int H, int W, int Cin, int Cout,
                                     int relu, int ck, int stages, int dc,
                                     int chunks, int tiles_h, int tiles_w,
                                     int blocks, int smem, void* stream) {
  const conv3d_wgmma::Geometry g{B, R, P, H, W, Cin, Cout, relu,
                                 dc, chunks, tiles_h, tiles_w, stages};
  return conv3d_wgmma::launch(x, w, scale, bias, out, g, ck, blocks, smem,
                              stream);
}

// Registers a thread of the packed_conv3d_v2_bf16 kernel of channel slice ck
// (16, 32 or 64), for the launch plan's residency; minus the CUDA error
// code when they cannot be read.
extern "C" int packed_conv3d_v2_bf16_regs(int ck) {
  return conv3d_wgmma::registers(ck);
}
