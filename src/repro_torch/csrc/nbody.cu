// All-pairs N-body accelerations for Hopper (sm_90a): softened gravity,
// G = 1, f32 in and out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/nbody/kernel.py::nbody
// (its body _nbody_kernel, the inverse cube from _inv_r3).  Same function,
// same tunables; the blocks are Hopper's.
//
//   a_i = G * sum_j m_j (x_j - x_i) / (|x_j - x_i|^2 + eps2)^(3/2)
//
//   bodies as pos (3, N) rows x, y, z plus mass (N,) (layout soa), or as
//   one (N, 4) array of float4 x, y, z, m (layout aos, the paper's
//   use_soa = 0); out (3, N) f32.  N is a multiple of block_i and block_j.
//
// Design.  A block of block_i threads owns block_i bodies i, one a thread,
// and walks all N bodies j in tiles of block_j: the block stages a tile in
// shared memory as float4 (x, y, z, m), 16 B a body, then each thread runs
// over it, UNROLL bodies per unrolled chunk.  The three sums stay in
// registers and run in j order, tile after tile; the i bodies of a block
// share every staged tile, so device memory is read N / block_i times over,
// from L2.  rsqrt_method exact is IEEE 1.0f / sqrtf(r2) (no fast math);
// approx is rsqrtf with one Newton step, as _inv_r3.  compute_dtype bf16
// rounds the positions to bf16 and each of the three differences to bf16,
// as the reference computes them in bf16; the rest stays f32.
//
// Bound at the default shape (N = 131 072; H100 SXM data sheet): 131 072^2
// pairs at 20 FLOP each (the CUDA SDK's count per interaction) are 343.6
// GFLOP, 5.1 ms at 67 TFLOP/s f32; the bodies and output (3.7 MB) take
// 0.001 ms at 3.35 TB/s.  So the kernel is bound by its f32 operations;
// the exact path's IEEE square root and division, and bf16's roundings,
// are extra instructions on top of the count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float G = 1.0f;
constexpr int MAX_THREADS = 512;   // block_i at most
constexpr int MAX_BLOCK_J = 4096;  // 64 KB of staged bodies

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int UNROLL, int EXACT, int BF16>
__global__ void __launch_bounds__(MAX_THREADS, 1)
nbody_kernel(const float* __restrict__ pos, const float* __restrict__ mass,
             const float4* __restrict__ bodies, float* __restrict__ out, int n, int block_j,
             int aos, float eps2) {
  extern __shared__ float4 tile[];  // block_j bodies
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float xi, yi, zi;
  if (aos) {
    const float4 b = bodies[i];
    xi = b.x, yi = b.y, zi = b.z;
  } else {
    xi = pos[i], yi = pos[n + i], zi = pos[2 * n + i];
  }
  if (BF16) xi = bf16_round(xi), yi = bf16_round(yi), zi = bf16_round(zi);
  float ax = 0.f, ay = 0.f, az = 0.f;

  for (int j0 = 0; j0 < n; j0 += block_j) {
    __syncthreads();  // the previous tile is consumed
    for (int k = threadIdx.x; k < block_j; k += blockDim.x) {
      const int j = j0 + k;
      float4 b = aos ? bodies[j] : make_float4(pos[j], pos[n + j], pos[2 * n + j], mass[j]);
      if (BF16) b.x = bf16_round(b.x), b.y = bf16_round(b.y), b.z = bf16_round(b.z);
      tile[k] = b;
    }
    __syncthreads();
    const int chunks = block_j / UNROLL;
#pragma unroll 1
    for (int c = 0; c < chunks; ++c) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float4 b = tile[c * UNROLL + u];
        float dx = b.x - xi, dy = b.y - yi, dz = b.z - zi;
        if (BF16) dx = bf16_round(dx), dy = bf16_round(dy), dz = bf16_round(dz);
        const float r2 = dx * dx + dy * dy + dz * dz + eps2;
        float inv;
        if (EXACT) {
          inv = 1.0f / sqrtf(r2);
        } else {
          const float y = rsqrtf(r2);
          inv = y * (1.5f - 0.5f * r2 * y * y);
        }
        const float w = b.w * (inv * inv * inv);
        ax += dx * w;
        ay += dy * w;
        az += dz * w;
      }
    }
  }
  out[i] = G * ax;
  out[n + i] = G * ay;
  out[2 * n + i] = G * az;
}

template <int UNROLL, int EXACT, int BF16>
int launch_tile(const float* pos, const float* mass, const float4* bodies, float* out, int n,
                int block_i, int block_j, int aos, float eps2, cudaStream_t stream) {
  constexpr auto kern = nbody_kernel<UNROLL, EXACT, BF16>;
  const cudaError_t e = opt_in_smem<kern>(MAX_BLOCK_J * sizeof(float4));
  if (e != cudaSuccess) return e;
  kern<<<n / block_i, block_i, block_j * sizeof(float4), stream>>>(pos, mass, bodies, out, n,
                                                                   block_j, aos, eps2);
  return cudaGetLastError();
}

template <int UNROLL, int EXACT, int BF16>
int tile_attributes(int* regs, int* local_bytes, int* max_threads) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, nbody_kernel<UNROLL, EXACT, BF16>);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *max_threads = attr.maxThreadsPerBlock;
  return cudaSuccess;
}

}  // namespace

#define NB_EXACTS(X, U_) X(U_, 0, 0) X(U_, 0, 1) X(U_, 1, 0) X(U_, 1, 1)
#define NB_TILES(X) NB_EXACTS(X, 1) NB_EXACTS(X, 2) NB_EXACTS(X, 4) NB_EXACTS(X, 8)

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// With aos, `bodies` is the (N, 4) array and pos and mass are unused; else
// the reverse.  block_i (at most 512) and block_j (at most 4096) divide n,
// and unroll divides block_j.
int nbody_launch(const void* pos, const void* mass, const void* bodies, void* out, int n,
                 int block_i, int block_j, int unroll, int exact, int bf16, int aos, float eps2,
                 void* stream) {
  if (n < 1 || block_i < 1 || block_i > MAX_THREADS || block_j < 1 || block_j > MAX_BLOCK_J ||
      n % block_i != 0 || n % block_j != 0 || unroll < 1 || block_j % unroll != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  const float* m = static_cast<const float*>(mass);
  const float4* b = static_cast<const float4*>(bodies);
  float* o = static_cast<float*>(out);
#define NB_DISPATCH(U_, E_, B_)                  \
  if (unroll == U_ && exact == E_ && bf16 == B_) \
    return launch_tile<U_, E_, B_>(p, m, b, o, n, block_i, block_j, aos, eps2, st);
  NB_TILES(NB_DISPATCH)
#undef NB_DISPATCH
  return cudaErrorInvalidValue;
}

// Registers, local (spill) bytes and the most threads a block may have, of
// one compiled tile.
int nbody_attributes(int unroll, int exact, int bf16, int* regs, int* local_bytes,
                     int* max_threads) {
#define NB_ATTRS(U_, E_, B_)                     \
  if (unroll == U_ && exact == E_ && bf16 == B_) \
    return tile_attributes<U_, E_, B_>(regs, local_bytes, max_threads);
  NB_TILES(NB_ATTRS)
#undef NB_ATTRS
  return cudaErrorInvalidValue;
}

const char* nbody_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
