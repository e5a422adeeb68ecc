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
// Design.  A block owns block_d DMs x time_chunk samples of the output.  Its
// threads form block_d / UD rows of nx threads, nx a whole number of warps,
// so a warp shares its DMs: a row owns UD DMs (unroll_d) and a thread ST
// samples of each, nx apart; the accumulators, UD x ST of them, stay in
// registers.  The block walks its chunk in passes of nx x ST samples, and
// each pass walks the channels in steps of block_c.
//
// The samples come from shared memory, staged ahead of the adds.  For each
// channel the block stages one window of x, what its DMs read in the pass:
// [p0 + dmin, p0 + pass + dmax), where dmin and dmax are the least and
// greatest delay of the block's DMs in that channel (computed once per
// block, before the passes), the start rounded down to 16 B.  A slot holds
// the pass plus T - t_out samples, the largest span any table the op
// accepts can have, so every table fits; only the window is copied.  The
// slots form a ring of `stages` steps of block_c channels (as many steps as
// fit in shared memory, 2 to 8).  As step q begins, thread 0 stages step
// q + stages - 1 by bulk copies (cp.async.bulk of the windows and the
// step's delay slices) that complete on its entry's mbarrier, once every
// warp has released the step the entry held on a second one; each warp
// waits on the first, adds the step and releases it, so stages - 1 steps
// are in flight while one is added, and no block-wide barrier runs after
// the start.  (A producer warp beside 16 adding warps takes ptxas's
// register cap to 96, where 64 accumulators a thread spill.)  A warp reads 32 consecutive floats at any offset of a slot in
// one wavefront.
//
// One read per distinct delay.  A thread adds, for each channel, the window
// read at each of its UD DMs' delays; where a DM's delay equals the one
// before it, the samples just read are added again without a second read.
// A dispersion table's delays grow with DM, so equal delays are adjacent and
// that is one read per distinct delay (0.494 a sample-add at UD 8 on the
// reference's table, where 55 % of the delays sit at the clip); a table out
// of that order is summed exactly all the same, with a read per run.  The
// test is on the delays alone, so the branch is warp-uniform.
//
// A delay is clamped to [0, T - t_out], which changes no valid table and
// keeps every read inside x.  Each output is a sequential sum over the
// channels 0 ... C-1, adds only, so the kernel follows its plain PyTorch
// version bit for bit in both acc_dtypes: in bf16 each sample is rounded to
// bf16 and each add rounded to bf16 (__fadd_rn, then the rounding), as the
// reference's bf16 accumulator adds.
//
// Bound at the default shape (1536 channels, 2048 DMs, 4096 samples out of
// 12 288): C x D x t_out = 1.29e10 adds take 0.385 ms at 3.35e13 f32
// instructions/s; x, the delays and out (122 MB) take 0.036 ms at 3.35
// TB/s.  So it is bound by its operations.  A shared-memory read serves 32
// adds of a warp; at UD 8 about half of the adds need one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int MAX_THREADS = 512;
constexpr int MAX_SMEM = 232448;  // per block, above 48 KB by opt-in
constexpr int MAX_STAGES = 8;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory; completion adds them to `bar`'s transactions.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Each channel's (dmin, dmax), an int2 a channel, the count rounded up to
// even so that what follows stays 16-byte aligned.
__host__ __device__ __forceinline__ int win_bytes(int c_dim) { return 8 * (c_dim + (c_dim & 1)); }

// A step of the ring: block_c slots of `slot` floats, block_c delay slices
// of block_d ints, and its two mbarriers (full, empty).
__host__ __device__ __forceinline__ int stage_bytes(int bd, int bc, int slot) {
  return bc * (slot + bd) * 4 + 16;
}

// Steps in the ring: as many as fit beside the channels' bounds, at most
// MAX_STAGES.
int ring_stages(int c_dim, int bd, int bc, int slot) {
  const int n = (MAX_SMEM - win_bytes(c_dim)) / stage_bytes(bd, bc, slot);
  return n < MAX_STAGES ? n : MAX_STAGES;
}

// The window of channel c in the pass [p0, pend): its first float (of x,
// rounded down to 16 B) and its length (rounded up to 16 B).
__device__ __forceinline__ void window(int c, int t_in, int p0, int pend, int2 wd,
                                       long long* first, int* n) {
  const long long row = static_cast<long long>(c) * t_in;
  *first = (row + p0 + wd.x) & ~3LL;
  *n = static_cast<int>((row + pend + wd.y - *first + 3) & ~3LL);
}

template <int UD, int ST, int BF16>
__global__ void __launch_bounds__(MAX_THREADS, 1)
dedisp_kernel(const float* __restrict__ x, const int* __restrict__ delays,
              float* __restrict__ out, int c_dim, int t_in, int d_dim, int d_stride, int t_out,
              int bd, int bc, int tc, int nx, int slot, int stages) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                                // [stage][cc][slot]
  int* sdel = reinterpret_cast<int*>(ring + stages * bc * slot);     // [stage][cc][bd]
  int2* win = reinterpret_cast<int2*>(sdel + stages * bc * bd);      // [c]
  uint64_t* full = reinterpret_cast<uint64_t*>(win + c_dim + (c_dim & 1));
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int tx = tid % nx, g = tid / nx;  // the thread's sample and row
  const int d0 = blockIdx.y * bd, t0 = blockIdx.x * tc;
  const int dlast = min(d0 + bd, d_dim) - 1;  // DMs past it read its delays
  const int tend = min(t0 + tc, t_out);
  const int max_delay = t_in - t_out;
  const int pass = nx * ST;
  const int nsteps = cdiv(c_dim, bc);
  const int nq = cdiv(tend - t0, pass) * nsteps;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      barrier_init(&full[s], 1);
      barrier_init(&empty[s], nwarps);
    }
    fence_barrier_init();
  }
  // Each channel's window: the least and greatest (clamped) delay of the
  // block's DMs.  The segment of min(bd, 32) lanes that holds one channel's
  // delays reduces them by shuffles; past 32 DMs, shared atomics join the
  // segments.
  const int seg = bd < 32 ? bd : 32;
  if (bd > 32) {
    for (int c = tid; c < c_dim; c += nthr) win[c] = make_int2(INT_MAX, INT_MIN);
    __syncthreads();
  }
  const int total = c_dim * bd;
#pragma unroll 4
  for (int base = warp * 32; base < total; base += nwarps * 32) {
    const int k = base + lane, c = k / bd;
    int lo = INT_MAX, hi = INT_MIN;
    if (k < total) {
      const int d = min(d0 + k - c * bd, dlast);
      const int v = min(max(__ldg(delays + static_cast<size_t>(c) * d_stride + d), 0), max_delay);
      lo = hi = v;
    }
    for (int o = 1; o < seg; o <<= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (k < total && lane % seg == 0) {
      if (bd <= 32) {
        win[c] = make_int2(lo, hi);
      } else {
        atomicMin(&win[c].x, lo);
        atomicMax(&win[c].y, hi);
      }
    }
  }
  __syncthreads();

  // Thread 0 is also the producer: it stages step q into ring entry q %
  // stages, once every warp has released the step that entry held, by
  // bulk copies that complete on the entry's full barrier; it stages step
  // q + stages - 1 as step q begins.
  int pst = 0, pstep = 0, pc0 = 0, pp0 = t0;
  uint32_t pphase = 1;  // a fresh ring is empty: the first pass waits on nothing
  auto issue = [&](int q) {
    if (q >= stages) barrier_wait(&empty[pst], pphase);
    const int pend = min(pp0 + pass, tend), nc = min(bc, c_dim - pc0);
    uint32_t bytes = 0;
    for (int cc = 0; cc < nc; ++cc) {
      long long first;
      int n;
      window(pc0 + cc, t_in, pp0, pend, win[pc0 + cc], &first, &n);
      bytes += (n + bd) * 4;
    }
    barrier_arrive_expect_tx(&full[pst], bytes);
    for (int cc = 0; cc < nc; ++cc) {
      const int c = pc0 + cc;
      long long first;
      int n;
      window(c, t_in, pp0, pend, win[c], &first, &n);
      bulk_load(ring + (pst * bc + cc) * slot, x + first, n * 4, &full[pst]);
      bulk_load(sdel + (pst * bc + cc) * bd, delays + static_cast<size_t>(c) * d_stride + d0,
                bd * 4, &full[pst]);
    }
    if (++pstep == nsteps) {
      pstep = pc0 = 0;
      pp0 += pass;
    } else {
      pc0 += bc;
    }
    if (++pst == stages) {
      pst = 0;
      pphase ^= 1;
    }
  };
  if (tid == 0)
    for (int q = 0; q < stages - 1 && q < nq; ++q) issue(q);

  // Every warp adds each step as it lands and releases it when read.
  float acc[UD][ST];
#pragma unroll
  for (int u = 0; u < UD; ++u)
#pragma unroll
    for (int s = 0; s < ST; ++s) acc[u][s] = 0.f;

  int st = 0, step = 0, c0 = 0, p0 = t0;
  uint32_t phase = 0;
#pragma unroll 1
  for (int q = 0; q < nq; ++q) {
    if (tid == 0 && q + stages - 1 < nq) issue(q + stages - 1);
    barrier_wait(&full[st], phase);
    const int nc = min(bc, c_dim - c0);
#pragma unroll 1
    for (int cc = 0; cc < nc; ++cc) {
      const int c = c0 + cc, dmin = win[c].x;
      // where the window's sample p0 + tx at delay 0 would sit in the slot:
      // only the low two bits of the row's start matter
      const int lead = static_cast<int>((static_cast<unsigned>(c) * t_in + p0 + dmin) & 3u) - dmin;
      const float* w = ring + (st * bc + cc) * slot + lead + tx;
      const int* dl = sdel + (st * bc + cc) * bd + g * UD;
      int v[UD];
      if (UD % 4 == 0) {
#pragma unroll
        for (int i = 0; i < UD / 4; ++i) {
          const int4 q4 = reinterpret_cast<const int4*>(dl)[i];
          v[4 * i] = q4.x;
          v[4 * i + 1] = q4.y;
          v[4 * i + 2] = q4.z;
          v[4 * i + 3] = q4.w;
        }
      } else if (UD == 2) {
        const int2 q2 = *reinterpret_cast<const int2*>(dl);
        v[0] = q2.x;
        v[UD - 1] = q2.y;
      } else {
        v[0] = dl[0];
      }
      float val[ST];
#pragma unroll
      for (int u = 0; u < UD; ++u) {
        if (u == 0 || v[u] != v[u > 0 ? u - 1 : 0]) {
          const float* r = w + min(max(v[u], 0), max_delay);
#pragma unroll
          for (int s = 0; s < ST; ++s) {
            const float f = r[s * nx];
            val[s] = BF16 ? bf16_round(f) : f;
          }
        }
#pragma unroll
        for (int s = 0; s < ST; ++s)
          acc[u][s] = BF16 ? bf16_round(__fadd_rn(acc[u][s], val[s])) : __fadd_rn(acc[u][s], val[s]);
      }
    }
    __syncwarp();
    if (lane == 0) barrier_arrive(&empty[st]);
    if (++st == stages) {
      st = 0;
      phase ^= 1;
    }

    if (++step == nsteps) {  // the pass is summed: write it, start the next
      const int pend = min(p0 + pass, tend);
#pragma unroll
      for (int u = 0; u < UD; ++u) {
        const int d = d0 + g * UD + u;
#pragma unroll
        for (int s = 0; s < ST; ++s) {
          const int t = p0 + tx + s * nx;
          if (d < d_dim && t < pend) out[static_cast<size_t>(d) * t_out + t] = acc[u][s];
          acc[u][s] = 0.f;
        }
      }
      step = c0 = 0;
      p0 += pass;
    } else {
      c0 += bc;
    }
  }
}

template <int UD, int ST, int BF16>
int launch_tile(const float* x, const int* delays, float* out, int c_dim, int t_in, int d_dim,
                int d_stride, int t_out, int bd, int bc, int tc, int nx, int slot, int stages,
                cudaStream_t stream) {
  constexpr auto kern = dedisp_kernel<UD, ST, BF16>;
  const int smem = stages * stage_bytes(bd, bc, slot) + win_bytes(c_dim);
  const cudaError_t e = opt_in_smem<kern>(smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(cdiv(t_out, tc), cdiv(d_dim, bd));
  kern<<<grid, nx * (bd / UD), smem, stream>>>(x, delays, out, c_dim, t_in, d_dim, d_stride,
                                                    t_out, bd, bc, tc, nx, slot, stages);
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

// (UD, ST) with UD x ST <= 64 accumulators and ST <= 16, in both acc_dtypes
#define DD_BF(X, U_, S_) X(U_, S_, 0) X(U_, S_, 1)
#define DD_TILES(X)                                                          \
  DD_BF(X, 1, 1) DD_BF(X, 1, 2) DD_BF(X, 1, 4) DD_BF(X, 1, 8) DD_BF(X, 1, 16) \
  DD_BF(X, 2, 1) DD_BF(X, 2, 2) DD_BF(X, 2, 4) DD_BF(X, 2, 8) DD_BF(X, 2, 16) \
  DD_BF(X, 4, 1) DD_BF(X, 4, 2) DD_BF(X, 4, 4) DD_BF(X, 4, 8) DD_BF(X, 4, 16) \
  DD_BF(X, 8, 1) DD_BF(X, 8, 2) DD_BF(X, 8, 4) DD_BF(X, 8, 8)

extern "C" {

// out (d_dim, t_out) on `stream`.  The block is nx x (block_d / unroll_d)
// threads (nx a multiple of 32, at most 512 in all); a thread owns
// `samples` samples (a power of two at most 16, unroll_d x samples <= 64)
// of unroll_d DMs; block_d a power of two of at
// least 8 that unroll_d divides; x 16-byte aligned and readable up to the
// next 16 B past its end; delays rows d_stride apart, d_stride a multiple of 4 and of block_d,
// at least d_dim, 16-byte aligned; a ring of at least two steps in
// 232 448 B of shared memory.  Returns the launch's cudaError_t (0 on success).
int dedisp_launch(const void* x, const void* delays, void* out, int c_dim, int t_in, int d_dim,
                  int d_stride, int t_out, int block_d, int block_c, int time_chunk, int unroll_d,
                  int nx, int samples, int acc_bf16, void* stream) {
  const int slot = (nx * samples + (t_in - t_out) + 6 + 3) & ~3;
  const int stages = ring_stages(c_dim, block_d, block_c, slot);
  if (c_dim < 1 || d_dim < 1 || t_out < 1 || t_in < t_out || block_d < 8 ||
      (block_d & (block_d - 1)) || block_c < 1 || time_chunk < 1 || unroll_d < 1 ||
      block_d % unroll_d || nx < 32 || nx % 32 || nx * (block_d / unroll_d) > MAX_THREADS ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(delays) % 16 || d_stride < d_dim || d_stride % 4 ||
      d_stride % block_d || stages < 2)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* px = static_cast<const float*>(x);
  const int* pd = static_cast<const int*>(delays);
  float* po = static_cast<float*>(out);
#define DD_DISPATCH(U_, S_, B_)                              \
  if (unroll_d == U_ && samples == S_ && acc_bf16 == B_)    \
    return launch_tile<U_, S_, B_>(px, pd, po, c_dim, t_in, d_dim, d_stride, t_out, block_d, \
                                   block_c, time_chunk, nx, slot, stages, st);
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
