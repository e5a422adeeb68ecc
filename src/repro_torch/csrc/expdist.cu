// ExpDist for Hopper (sm_90a): the Gaussian-overlap registration cost of two
// point sets, a scalar, f32 in and out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/expdist/kernel.py::
// expdist (its body _expdist_kernel, the far-point padding pad_far outside
// it, and the sum of the partials after it).  Same function, same tunables;
// the blocks are Hopper's.
//
//   D = sum_{i < ka, j < kb} exp(-|a_i - b_j|^2 / (2 (sa_i^2 + sb_j^2)))
//
//   a (2, ka), b (2, kb), sa (ka,), sb (kb,) f32 -> D, f32.
//
// Design.  Block (i, col) of a ceil(ka / block_i) x njb grid runs block_i
// threads, one point a_i each, and walks the j tiles col, col + njb, ...
// in order (njb = 1 with use_column, else min(n_y_blocks, ceil(kb /
// block_j)), the reference's column split).  Each j tile of block_j points
// (x, y and sb^2) is staged in shared memory; each thread sums its terms in
// f32 in j order, UJ terms per unrolled step (unroll_j), then the block
// adds its threads' sums in a fixed tree order and writes partial[i, col].
// A second launch, one block, adds the partials in a fixed order: strided
// sequential sums per thread, then a tree.  No float atomics, so a run
// repeats bit for bit.  Pairs past ka or kb are skipped, where the
// reference pads with far points whose terms underflow to exactly 0.
//
// compute_dtype bf16 rounds the four coordinates and the two differences
// to bf16, as the reference; sa^2, sb^2, r^2, the denominator, z and the
// exponential stay f32.  z = -r2 / denom is an IEEE division.  exp_variant
// is expf(z) or exp2f(z * LOG2E): no fast-math intrinsic, so both compute
// the reference's function.
//
// Bound at the default shape (65 536 x 65 536 pairs; H100 SXM data sheet,
// CUDA C++ Programming Guide throughput table for cc 9.0): each pair needs
// one reciprocal (the division) and one exp2 on the special-function
// units, 16 results per clock per SM, 8.6e9 / 4.2e12/s = 2.05 ms; its 10
// f32 operations take 0.64 ms at 67 TFLOP/s, and the 1.5 MB of inputs
// nothing.  So it is bound by the special-function units.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 512;
constexpr int SUM_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int EXP2, int BF16>
__device__ __forceinline__ float term(float ax, float ay, float sa2, float bx, float by,
                                      float sb2) {
  float dx = ax - bx, dy = ay - by;
  if (BF16) {
    dx = bf16_round(dx);
    dy = bf16_round(dy);
  }
  const float r2 = dx * dx + dy * dy;
  const float denom = 2.f * (sa2 + sb2);
  const float z = -r2 / denom;
  return EXP2 ? exp2f(z * LOG2E) : expf(z);
}

template <int UJ, int EXP2, int BF16>
__global__ void __launch_bounds__(MAX_THREADS)
expdist_kernel(const float* __restrict__ a, const float* __restrict__ sa,
               const float* __restrict__ b, const float* __restrict__ sb,
               float* __restrict__ partial, int ka, int kb, int bj, int njb) {
  extern __shared__ float smem[];
  float* sbx = smem;
  float* sby = smem + bj;
  float* ssb2 = smem + 2 * bj;
  float* red = smem + 3 * bj;  // blockDim.x
  const int tid = threadIdx.x;
  const int i = blockIdx.x * blockDim.x + tid;
  const int col = blockIdx.y;
  const bool live = i < ka;
  float ax = 0.f, ay = 0.f, sa2 = 1.f;
  if (live) {
    ax = a[i];
    ay = a[ka + i];
    const float s = sa[i];
    sa2 = s * s;
    if (BF16) {
      ax = bf16_round(ax);
      ay = bf16_round(ay);
    }
  }
  float acc = 0.f;
  const int gj = (kb + bj - 1) / bj;
#pragma unroll 1
  for (int jt = col; jt < gj; jt += njb) {
    const int j0 = jt * bj;
    const int n = kb - j0 < bj ? kb - j0 : bj;
    __syncthreads();
    for (int k = tid; k < n; k += blockDim.x) {
      float bx = b[j0 + k], by = b[kb + j0 + k];
      if (BF16) {
        bx = bf16_round(bx);
        by = bf16_round(by);
      }
      const float s = sb[j0 + k];
      sbx[k] = bx;
      sby[k] = by;
      ssb2[k] = s * s;
    }
    __syncthreads();
    if (live) {
      int k = 0;
#pragma unroll 1
      for (; k + UJ <= n; k += UJ) {
#pragma unroll
        for (int u = 0; u < UJ; ++u)
          acc += term<EXP2, BF16>(ax, ay, sa2, sbx[k + u], sby[k + u], ssb2[k + u]);
      }
      for (; k < n; ++k) acc += term<EXP2, BF16>(ax, ay, sa2, sbx[k], sby[k], ssb2[k]);
    }
  }
  red[tid] = acc;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) partial[blockIdx.x * njb + col] = red[0];
}

// The partials' sum, one block: thread t adds partial[t], partial[t + 256],
// ... in order, then the block adds the threads' sums in a tree.
__global__ void __launch_bounds__(SUM_THREADS)
sum_partials(const float* __restrict__ partial, int n, float* __restrict__ out) {
  __shared__ float red[SUM_THREADS];
  float acc = 0.f;
  for (int k = threadIdx.x; k < n; k += SUM_THREADS) acc += partial[k];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = SUM_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = red[0];
}

template <int UJ, int EXP2, int BF16>
int launch_tile(const float* a, const float* sa, const float* b, const float* sb,
                float* partial, float* out, int ka, int kb, int bi, int bj, int njb,
                cudaStream_t stream) {
  constexpr auto kern = expdist_kernel<UJ, EXP2, BF16>;
  const int smem = (3 * bj + bi) * static_cast<int>(sizeof(float));
  const cudaError_t opt = opt_in_smem<kern>(smem);
  if (opt != cudaSuccess) return opt;
  const int gi = (ka + bi - 1) / bi;
  kern<<<dim3(gi, njb), bi, smem, stream>>>(a, sa, b, sb, partial, ka, kb, bj, njb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sum_partials<<<1, SUM_THREADS, 0, stream>>>(partial, gi * njb, out);
  return cudaGetLastError();
}

template <int UJ, int EXP2, int BF16>
int attributes_of(int* regs, int* local_bytes, int* max_threads) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, expdist_kernel<UJ, EXP2, BF16>);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *max_threads = attr.maxThreadsPerBlock;
  return cudaSuccess;
}

}  // namespace

#define EXP_BF(X, U_, E_) X(U_, E_, 0) X(U_, E_, 1)
#define EXP_VAR(X, U_) EXP_BF(X, U_, 0) EXP_BF(X, U_, 1)
#define EXP_TILES(X) EXP_VAR(X, 1) EXP_VAR(X, 2) EXP_VAR(X, 4)

extern "C" {

// D into out[0] on `stream`; partial holds ceil(ka / block_i) * njb floats.
// block_i is a power of two from 32 to 512, block_j a multiple of unroll_j
// (1, 2 or 4), 1 <= njb <= ceil(kb / block_j).  Returns the cudaError_t of
// the launches (0 on success).
int expdist_launch(const void* a, const void* sa, const void* b, const void* sb, void* partial,
                   void* out, int ka, int kb, int block_i, int block_j, int njb, int unroll_j,
                   int exp2, int bf16, void* stream) {
  if (ka < 1 || kb < 1 || block_i < 32 || block_i > MAX_THREADS || (block_i & (block_i - 1)) ||
      block_j < 1 || njb < 1 || njb > (kb + block_j - 1) / block_j || unroll_j < 1 ||
      block_j % unroll_j)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(a);
  const float* psa = static_cast<const float*>(sa);
  const float* pb = static_cast<const float*>(b);
  const float* psb = static_cast<const float*>(sb);
  float* pp = static_cast<float*>(partial);
  float* po = static_cast<float*>(out);
#define EXP_DISPATCH(U_, E_, B_)                        \
  if (unroll_j == U_ && exp2 == E_ && bf16 == B_)      \
    return launch_tile<U_, E_, B_>(pa, psa, pb, psb, pp, po, ka, kb, block_i, block_j, njb, st);
  EXP_TILES(EXP_DISPATCH)
#undef EXP_DISPATCH
  return cudaErrorInvalidValue;
}

// Registers, local (spill) bytes and the most threads a block may have, of
// one compiled tile.
int expdist_attributes(int unroll_j, int exp2, int bf16, int* regs, int* local_bytes,
                       int* max_threads) {
#define EXP_ATTRS(U_, E_, B_)                      \
  if (unroll_j == U_ && exp2 == E_ && bf16 == B_) \
    return attributes_of<U_, E_, B_>(regs, local_bytes, max_threads);
  EXP_TILES(EXP_ATTRS)
#undef EXP_ATTRS
  return cudaErrorInvalidValue;
}

const char* expdist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
