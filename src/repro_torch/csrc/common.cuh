// Helpers shared by the port's kernels: cp.async copies into shared
// memory, bf16 pairs packed into (and read from) 32-bit words, and the
// launchers' opt-in to more than 48 KB of dynamic shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The devices whose opt-in is remembered; on a device beyond them the
// attribute is set at every launch that needs it.
constexpr int MAX_DEVICES = 64;

// Let kernel K launch with `bytes` of dynamic shared memory on the current
// device, where that is above the 48 KB any kernel may take.  The opt-in
// is remembered per kernel, per device and per host thread, raised to the
// most asked there: one remembered per process would leave a second
// card's first launch refused, and on the H100 a launch from a second
// host thread of a kernel opted in by another thread is refused too
// ("invalid argument"), so each thread sets the attribute once itself.
template <auto K>
cudaError_t opt_in_smem(int bytes) {
  static thread_local int opted[MAX_DEVICES] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && bytes <= opted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < MAX_DEVICES) opted[dev] = bytes;
  return e;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Copy 16 bytes, of which the first src_bytes (0 to 16) come from gmem and
// the rest are zero; with src_bytes 0 nothing is read.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n groups are in flight (wait_group takes an immediate).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    default: asm volatile("cp.async.wait_group 0;\n" ::); break;
  }
}

// Round two floats to bf16 (to nearest even) and pack them, the first in the
// low half; and read either half back.  No local's address is taken, which
// would put it in local memory.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

}  // namespace
