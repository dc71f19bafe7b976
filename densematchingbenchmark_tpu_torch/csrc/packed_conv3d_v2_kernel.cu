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
// d1 - 1 of one batch item (dc of 4 to 16, see (a)), and walks the input
// depth planes z = d0 - 1 .. d1 in order. Each input plane, with its H / W
// halo, is staged in shared memory once and feeds the three outputs it
// touches: z + 1 (depth tap 0), z (tap 1) and z - 1 (tap 2), whose sums
// stay in registers. When plane z has been consumed, output z - 1 is
// complete and goes through the epilogue. K4, by contrast, stages each
// input plane once per output depth tap (three times). The stages are
// (plane, 8-channel slice of Cin) pairs: the zero-masked (4+2) x (32+2) x 8
// halo and the 27 weight taps of that slice for the block's 32 output
// channels, double-buffered and loaded with cp.async (zero-filled where
// masked) while the previous stage computes: the counterpart of the ring's
// prefetch. The packing is addressing, as in K4: input depth z at packed
// row z / P, slot z % P.
//
// What bounds the float32 route on an H100: arithmetic, as K4
// (conv3d_tile.cuh): 2*27*Cin*Cout flops per output voxel on the CUDA cores
// (67 TFLOP/s float32). The ring's saving is traffic, which does not bound
// this route; it does bound the bfloat16 one, whose products run on the
// tensor cores.
//
// Design choices against the three limits of this card:
// (a) Occupancy. Taking depth off the grid leaves few blocks (the 64->64
//     microbench case, 1 x 24 x 48 x 156, has 60 tiles x 2 Cout blocks), so
//     depth is cut into chunks, each restaging a two-plane halo (dc + 2
//     planes staged for dc outputs, against K4's 3 per output). The two
//     halo planes run only the one depth tap that feeds the chunk (a
//     compile-time variant of the stage, since a branch among the unrolled
//     FMAs ran slower on the card than doing the extra taps); planes d0 and
//     d1 - 1 run one tap whose sums are never stored, so a chunk does the
//     products of 3 * dc + 2 taps for 3 * dc. The launcher picks dc from
//     16, 12, 8, 6, 4 to minimise waves x (3 * dc + 2), a wave being the
//     blocks resident on the card at once: at the microbench's
//     full-resolution cases that is dc = 16 (720 blocks), at its 64->64
//     case dc = 12 (240 blocks, one wave, where dc = 8 leaves a second
//     wave of 96 blocks).
// (b) Shared memory. One stage is 6*34*8 halo values + 27*8*32 weights: 33.4
//     KB; two stages need 66.8 KB, above the 48 KB of static shared
//     memory, so it is dynamic shared memory with cudaFuncSetAttribute. A
//     thread reads 8 channels of a halo position in two 16-byte loads, so
//     no bank padding is needed.
// (c) Registers. Three accumulators of 4 rows x 8 channels (96) beside 4 x 8
//     staged inputs and the weights that the compiler loads ahead: ptxas
//     gives 255 registers and no spills, so 2 blocks (8 warps) per SM; a
//     cap of 168 (3 blocks) spilled and ran slower on the card.
// Needs Cin % 4 == 0 and Cout % 4 == 0 (4-value cp.async chunks); ragged
// H, W, Cin and Cout edges are masked.

#include "conv3d_tile.cuh"
#include "conv3d_wgmma.cuh"

namespace {

using conv3d_tile::load4;
using conv3d_tile::store4;

constexpr int TH = 4;            // output rows per block
constexpr int TW = 32;           // output columns per block
constexpr int CO_B = 32;         // output channels per block
constexpr int CO_T = 8;          // output channels per thread
constexpr int NT = 128;          // threads: 32 columns x 4 channel groups
constexpr int CK = 8;            // input channels per stage
constexpr int HR = TH + 2;       // halo rows
constexpr int HC = TW + 2;       // halo columns
constexpr int HALO = HR * HC * CK;         // values per stage: halo
constexpr int STAGE = HALO + 27 * CK * CO_B;   // halo + weights

constexpr int SMEM_BYTES = 2 * STAGE * static_cast<int>(sizeof(float));

// 4 float32 values from global to shared memory, asynchronously; zeros
// where !valid (nothing is read then).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  constexpr int N = 4 * sizeof(float);
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(N), "r"(valid ? N : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 8 consecutive float32 values of shared memory (32-byte aligned).
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Epilogue of one output depth d's sums a (this thread's column xx, rows
// y0 .., channels co0 + cg * CO_T ..): out = a * scale + bias per packed
// channel, optional ReLU.
__device__ __forceinline__ void store_depth(
    const float (&a)[TH][CO_T], float* __restrict__ out,
    const float* __restrict__ scale, const float* __restrict__ bias, int d,
    int b, int R, int P, int H, int W, int Cout, int y0, int xx, int co0,
    int cg, int relu) {
  if (xx >= W) return;
  const long long out_vox = (long long)P * Cout;
  const long long out_plane = ((long long)b * R + d / P) * H;
  const int slot = (d % P) * Cout;
#pragma unroll
  for (int g = 0; g < CO_T / 4; ++g) {
    const int co = co0 + cg * CO_T + g * 4;
    if (co >= Cout) continue;                   // Cout % 4 == 0: all 4 or none
    const float4 s = load4(scale + slot + co);
    const float4 o = load4(bias + slot + co);
#pragma unroll
    for (int i = 0; i < TH; ++i) {
      const int yy = y0 + i;
      if (yy >= H) break;
      float4 v;
      v.x = fmaf(a[i][g * 4 + 0], s.x, o.x);
      v.y = fmaf(a[i][g * 4 + 1], s.y, o.y);
      v.z = fmaf(a[i][g * 4 + 2], s.z, o.z);
      v.w = fmaf(a[i][g * 4 + 3], s.w, o.w);
      if (relu) {
        v.x = fmaxf(v.x, 0.f); v.y = fmaxf(v.y, 0.f);
        v.z = fmaxf(v.z, 0.f); v.w = fmaxf(v.w, 0.f);
      }
      store4(out + ((out_plane + yy) * W + xx) * out_vox + slot + co, v);
    }
  }
}

// One stage's products: the staged halo hs and weights ws (one 8-channel
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
      load8(hs + ((i + dh) * HC + vx + dw) * CK, a[i]);
#pragma unroll
    for (int c = 0; c < CK; ++c) {
#pragma unroll
      for (int dd = 0; dd < 3; ++dd) {
        if (ONLY >= 0 && dd != ONLY) continue;
        float wv[CO_T];
        load8(ws + ((dd * 9 + tap) * CK + c) * CO_B + cg * CO_T, wv);
#pragma unroll
        for (int i = 0; i < TH; ++i)
#pragma unroll
          for (int k = 0; k < CO_T; ++k)
            acc[2 - dd][i][k] = fmaf(a[i][c], wv[k], acc[2 - dd][i][k]);
      }
    }
  }
}

__global__ void __launch_bounds__(NT)
packed_conv3d_v2_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        float* __restrict__ out,
                        int R, int P, int H, int W, int Cin, int Cout,
                        int relu, int dc, int chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const smem = reinterpret_cast<float*>(smem_raw);

  const int D = R * P;                          // true depth
  const int t = threadIdx.x;
  const int cg = t & 3;                         // channel group: CO_T channels
  const int vx = t >> 2;                        // output column in the tile
  const int tiles_w = (W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int b = blockIdx.y / chunks;
  const int d0 = (blockIdx.y % chunks) * dc;    // outputs d0 .. d1 - 1
  const int d1 = min(d0 + dc, D);
  const int co0 = blockIdx.z * CO_B;
  const long long in_vox = (long long)P * Cin;  // values per packed voxel
  const int zs = max(d0 - 1, 0);                // input planes zs .. ze
  const int ze = min(d1, D - 1);
  const int slices = (Cin + CK - 1) / CK;
  const int steps = (ze - zs + 1) * slices;

  // stage `s` (plane zs + s / slices, channels (s % slices) * CK ...) into
  // buffer s & 1
  auto load_stage = [&](int s) {
    const int z = zs + s / slices;
    const int c0 = (s % slices) * CK;
    float* const hs = smem + (s & 1) * STAGE;
    float* const ws = hs + HALO;
    const long long plane = ((long long)b * R + z / P) * H;
    const float* const xs = x + (z % P) * Cin;
    for (int e = t; e < HR * HC * (CK / 4); e += NT) {
      const int q = e % (CK / 4);
      const int pos = e / (CK / 4);
      const int yy = y0 + pos / HC - 1;
      const int xx = x0 + pos % HC - 1;
      const int c = c0 + q * 4;
      const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W && c < Cin;
      cp_async4(hs + pos * CK + q * 4,
                ok ? xs + ((plane + yy) * W + xx) * in_vox + c : x, ok);
    }
    for (int e = t; e < 27 * CK * (CO_B / 4); e += NT) {
      const int q = e % (CO_B / 4);
      const int rest = e / (CO_B / 4);
      const int c = rest % CK;
      const int tap = rest / CK;                // dd * 9 + dh * 3 + dw
      const int ci = c0 + c;
      const int co = co0 + q * 4;
      const bool ok = ci < Cin && co < Cout;
      cp_async4(ws + (tap * CK + c) * CO_B + q * 4,
                ok ? w + ((long long)tap * Cin + ci) * Cout + co : w, ok);
    }
    cp_async_commit();
  };

  // acc[j] sums output depth z - 1 + j while plane z is consumed
  float acc[3][TH][CO_T];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < TH; ++i)
#pragma unroll
      for (int k = 0; k < CO_T; ++k) acc[j][i][k] = 0.f;

  load_stage(0);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();      // stage s landed for all; stage s - 1 is read
    if (s + 1 < steps) load_stage(s + 1);
    const float* const hs = smem + (s & 1) * STAGE;
    const int z = zs + s / slices;
    // the halo planes d0 - 1 and d1 feed one output of the chunk each;
    // planes d0 and d1 - 1 feed one output outside it, whose sums are
    // never stored
    if (z == d0 - 1)
      compute_stage<0>(hs, hs + HALO, acc, vx, cg);
    else if (z == d1)
      compute_stage<2>(hs, hs + HALO, acc, vx, cg);
    else
      compute_stage<-1>(hs, hs + HALO, acc, vx, cg);
    if (s % slices == slices - 1) {
      // plane z consumed: output z - 1 is complete
      if (z - 1 >= d0)
        store_depth(acc[0], out, scale, bias, z - 1, b, R, P, H, W, Cout, y0,
                    x0 + vx, co0, cg, relu);
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
                x0 + vx, co0, cg, relu);
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

}  // namespace

// xp [B, R, H, W, P*Cin], w [3, 3, 3, Cin, Cout] (true, unpacked), out
// [B, R, H, W, P*Cout], all float32; scale / bias [P*Cout] float32; all
// contiguous, 16-byte aligned, with Cin % 4 == 0, Cout % 4 == 0 and
// B * R * P <= 65535 (checked by the caller).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int packed_conv3d_v2_f32(const float* x, const float* w,
                                    const float* scale, const float* bias,
                                    float* out, int B, int R, int P, int H,
                                    int W, int Cin, int Cout, int relu,
                                    void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      packed_conv3d_v2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // resident blocks on the card: SMs x blocks per SM (registers bound it)
  static int slots = 0;
  if (slots == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, packed_conv3d_v2_kernel, NT, SMEM_BYTES);
    slots = sms * per_sm > 0 ? sms * per_sm : 1;
  }
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
      x, w, scale, bias, out, R, P, H, W, Cin, Cout, relu, dc, chunks);
  return static_cast<int>(cudaGetLastError());
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
  return conv3d_wgmma::launch<3>(x, w, scale, bias, out, g, ck, blocks, smem,
                                 stream);
}

// Registers a thread of the packed_conv3d_v2_bf16 kernel of channel slice ck
// (16, 32 or 64), for the launch plan's residency; minus the CUDA error
// code when they cannot be read.
extern "C" int packed_conv3d_v2_bf16_regs(int ck) {
  return conv3d_wgmma::registers<3>(ck);
}
