// Dedispersion for Hopper (sm_90a): the sum over frequency channels of each
// channel's samples shifted by its delay at each dispersion measure (DM),
// f32 in and out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/dedisp/kernel.py::
// dedisp (its body _dedisp_kernel, with the delay table scalar-prefetched).
// Same function, same tunables; the blocks are Hopper's.
//
//   out(d, t) = sum_{c < C} x(c, t + delay(c, d)),   t < t_out
//
//   x (C, T) f32, delays (C, D) int32 -> out (D, t_out) f32.
//
// Design.  A block owns block_d DMs x time_chunk samples of the output.
// Its threads form block_d / UD rows of TX threads: a row owns UD DMs
// (unroll_d) and a thread ST samples of each, TX apart, so a warp reads
// consecutive samples; the accumulators, UD x ST of them, stay in
// registers.  The block walks its chunk in passes of TX x ST samples.  In
// a pass it walks the channels in steps of block_c: it stages the step's
// (block_c x block_d) slice of the delay table in shared memory (the table
// is 12.6 MB at the reference's shape, too large for constant memory; this
// replaces the reference's scalar prefetch), then each thread adds, channel
// by channel in order, the samples x(c, t + delay) of its DMs, read through
// the L1 cache (__ldg).  The x windows are not staged: one channel's window
// for a DM block spans time_chunk plus the delays of the block's DMs, up to
// 8192 samples more at the reference's shape.  A delay is clamped to [0, T -
// t_out], which changes no valid table and keeps every read inside x.
//
// Each output is a sequential sum over the channels 0 ... C-1, adds only,
// so the kernel follows its plain PyTorch version bit for bit in both
// acc_dtypes: in bf16 each sample is rounded to bf16 and each add rounded
// to bf16 (__fadd_rn, then the rounding), as the reference's bf16
// accumulator adds.
//
// Bound at the default shape (1536 channels, 2048 DMs, 4096 samples out of
// 12 288; H100 SXM data sheet): C x D x t_out = 1.29e10 adds take 0.19 ms
// at 67 TFLOP/s; x, the delays and out (122 MB) take 0.036 ms at 3.35
// TB/s.  So it is bound by its operations.  Each add here is also one L1
// load, whose rate (128 B per clock per SM) caps the kernel near 1.5 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 512;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int UD, int ST, int BF16>
__global__ void __launch_bounds__(MAX_THREADS, 1)
dedisp_kernel(const float* __restrict__ x, const int* __restrict__ delays,
              float* __restrict__ out, int c_dim, int t_in, int d_dim, int t_out, int bd, int bc,
              int tc) {
  extern __shared__ int sdel[];  // bc x bd
  const int tx = threadIdx.x, g = threadIdx.y, nx = blockDim.x;
  const int tid = g * nx + tx, nthr = nx * blockDim.y;
  const int d0 = blockIdx.y * bd, t0 = blockIdx.x * tc;
  const int tend = t0 + tc < t_out ? t0 + tc : t_out;
  const int max_delay = t_in - t_out;

#pragma unroll 1
  for (int p0 = t0; p0 < tend; p0 += nx * ST) {
    float acc[UD][ST];
#pragma unroll
    for (int u = 0; u < UD; ++u)
#pragma unroll
      for (int s = 0; s < ST; ++s) acc[u][s] = 0.f;

#pragma unroll 1
    for (int c0 = 0; c0 < c_dim; c0 += bc) {
      const int nc = c_dim - c0 < bc ? c_dim - c0 : bc;
      __syncthreads();
      for (int k = tid; k < nc * bd; k += nthr) {
        const int cc = k / bd, d = d0 + k - cc * bd;
        const int v = d < d_dim ? delays[static_cast<size_t>(c0 + cc) * d_dim + d] : 0;
        sdel[k] = v < 0 ? 0 : (v > max_delay ? max_delay : v);
      }
      __syncthreads();
#pragma unroll 1
      for (int cc = 0; cc < nc; ++cc) {
        const float* row = x + static_cast<size_t>(c0 + cc) * t_in + p0 + tx;
#pragma unroll
        for (int u = 0; u < UD; ++u) {
          const float* r = row + sdel[cc * bd + g * UD + u];
#pragma unroll
          for (int s = 0; s < ST; ++s) {
            if (p0 + tx + s * nx < tend) {
              const float v = __ldg(r + s * nx);
              if (BF16)
                acc[u][s] = bf16_round(__fadd_rn(acc[u][s], bf16_round(v)));
              else
                acc[u][s] = __fadd_rn(acc[u][s], v);
            }
          }
        }
      }
    }

#pragma unroll
    for (int u = 0; u < UD; ++u) {
      const int d = d0 + g * UD + u;
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        const int t = p0 + tx + s * nx;
        if (d < d_dim && t < tend) out[static_cast<size_t>(d) * t_out + t] = acc[u][s];
      }
    }
  }
}

template <int UD, int ST, int BF16>
int launch_tile(const float* x, const int* delays, float* out, int c_dim, int t_in, int d_dim,
                int t_out, int bd, int bc, int tc, int nx, cudaStream_t stream) {
  const int smem = bc * bd * static_cast<int>(sizeof(int));
  const dim3 grid((t_out + tc - 1) / tc, (d_dim + bd - 1) / bd);
  dedisp_kernel<UD, ST, BF16><<<grid, dim3(nx, bd / UD), smem, stream>>>(
      x, delays, out, c_dim, t_in, d_dim, t_out, bd, bc, tc);
  return cudaGetLastError();
}

template <int UD, int ST, int BF16>
int attributes_of(int* regs, int* local_bytes, int* max_threads) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, dedisp_kernel<UD, ST, BF16>);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *max_threads = attr.maxThreadsPerBlock;
  return cudaSuccess;
}

}  // namespace

// (UD, ST) with UD x ST <= 32 accumulators and ST <= 16 (UD 1 with 32
// samples spilled at 128 registers), in both acc_dtypes
#define DD_BF(X, U_, S_) X(U_, S_, 0) X(U_, S_, 1)
#define DD_TILES(X)                                                          \
  DD_BF(X, 1, 1) DD_BF(X, 1, 2) DD_BF(X, 1, 4) DD_BF(X, 1, 8) DD_BF(X, 1, 16) \
  DD_BF(X, 2, 1) DD_BF(X, 2, 2) DD_BF(X, 2, 4) DD_BF(X, 2, 8) DD_BF(X, 2, 16) \
  DD_BF(X, 4, 1) DD_BF(X, 4, 2) DD_BF(X, 4, 4) DD_BF(X, 4, 8)                 \
  DD_BF(X, 8, 1) DD_BF(X, 8, 2) DD_BF(X, 8, 4)

extern "C" {

// out (d_dim, t_out) on `stream`.  The block is nx x (block_d / unroll_d)
// threads (at most 512), each owning `samples` samples (a power of two at
// most 16, unroll_d x samples <= 32) of unroll_d DMs; unroll_d divides block_d,
// block_c x block_d ints fit in 48 KB.  Returns the launch's cudaError_t
// (0 on success).
int dedisp_launch(const void* x, const void* delays, void* out, int c_dim, int t_in, int d_dim,
                  int t_out, int block_d, int block_c, int time_chunk, int unroll_d, int nx,
                  int samples, int acc_bf16, void* stream) {
  if (c_dim < 1 || d_dim < 1 || t_out < 1 || t_in < t_out || block_d < 1 || block_c < 1 ||
      time_chunk < 1 || unroll_d < 1 || block_d % unroll_d || nx < 1 ||
      nx * (block_d / unroll_d) > MAX_THREADS || block_c * block_d * 4 > 48 * 1024)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* px = static_cast<const float*>(x);
  const int* pd = static_cast<const int*>(delays);
  float* po = static_cast<float*>(out);
#define DD_DISPATCH(U_, S_, B_)                              \
  if (unroll_d == U_ && samples == S_ && acc_bf16 == B_)    \
    return launch_tile<U_, S_, B_>(px, pd, po, c_dim, t_in, d_dim, t_out, block_d, block_c, \
                                   time_chunk, nx, st);
  DD_TILES(DD_DISPATCH)
#undef DD_DISPATCH
  return cudaErrorInvalidValue;
}

// Registers, local (spill) bytes and the most threads a block may have, of
// one compiled tile.
int dedisp_attributes(int unroll_d, int samples, int acc_bf16, int* regs, int* local_bytes,
                      int* max_threads) {
#define DD_ATTRS(U_, S_, B_)                                 \
  if (unroll_d == U_ && samples == S_ && acc_bf16 == B_)    \
    return attributes_of<U_, S_, B_>(regs, local_bytes, max_threads);
  DD_TILES(DD_ATTRS)
#undef DD_ATTRS
  return cudaErrorInvalidValue;
}

const char* dedisp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
