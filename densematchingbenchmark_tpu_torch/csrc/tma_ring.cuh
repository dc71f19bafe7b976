// The pieces of a shared-memory ring fed by the Tensor Memory Accelerator,
// shared by the port's three blocks that use one: the float32 trunk conv
// (conv3d_tile.cuh: K1 and K4's float32 route), K5's float32 kernel
// (packed_conv3d_v2_kernel.cu) and the bfloat16 wgmma block of K4 and K5
// (conv3d_wgmma.cuh).
//
// - mbarriers: a "full" barrier per ring slot completes when the slot's TMA
//   and bulk copies have landed (transaction bytes), an "empty" one when
//   every thread has read the slot, after which one thread refills it.
// - TMA: one copy of a box of a 5-D tensor map into shared memory; boxes
//   that reach past the tensor are zero-filled, which is how the conv
//   blocks get their SAME halo and their ragged channel slices.
// - Bulk copies of contiguous bytes (the weight images).
// - cuTensorMapEncodeTiled, looked up through the runtime.
// - Per-device kernel attributes: a kernel's shared-memory limit is set on
//   the kernel as loaded on one device, so it is set once per device, not
//   once per process.

#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>

#include <cstdint>

namespace tma_ring {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

// Make the barriers' initialisation visible to the async (TMA) proxy.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA copy of a box of the 5-D tensor map into shared memory,
// completing on the barrier.
__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// One bulk copy of `bytes` (a multiple of 16) contiguous bytes into shared
// memory, completing on the barrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (no link against libcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Error codes beside CUDA's: no entry point found, or the tensor map
// refused (1000 + the CUresult).
constexpr int NO_ENCODE = 999;

// Devices whose settings are kept per device; a device past them is set
// on every call.
constexpr int MAX_DEVICES = 64;

// The current device's ordinal, or -1 when it cannot be read.
inline int current_device() {
  int dev = -1;
  return cudaGetDevice(&dev) == cudaSuccess ? dev : -1;
}

// Allow `kernel` up to `bytes` of dynamic shared memory on the current
// device, once per device: `allowed` is the caller's table (one per
// kernel, zero-initialised) of the bytes already allowed on each device.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes,
                              int (&allowed)[MAX_DEVICES]) {
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (dev < MAX_DEVICES && allowed[dev] >= bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) allowed[dev] = bytes;
  return err;
}

}  // namespace tma_ring
