// Hotspot thermal stencil for Hopper (sm_90a): n sweeps of Rodinia's 5-point
// stencil over a 2-D domain, tt sweeps per launch, f32 in and out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hotspot/kernel.py::
// hotspot_step (its body _hotspot_kernel and _sweep_tile, the edge pad and
// halo gather outside it, _make_tiles) and its driver hotspot, which calls
// it ceil(n / tt) times.  Same function, same tunables; the blocks are
// Hopper's.
//
//   t' = t + step * (p + ry * (up + down - 2t) + rx * (left + right - 2t)
//                      + rz * (amb - t))
//
//   temp, power (H, W) f32 -> out (H, W) f32, n sweeps.
//
// Design.  One launch advances the domain `this` sweeps (tt, or what is
// left for the last launch).  A block owns a block_h x block_w output tile.
// It loads its (block_h + 2 this) x (block_w + 2 this) input tile, halo and
// all, into shared memory inside the kernel (in place of the reference's pad
// and gather outside it), sweeps it `this` times there, ping-ponging two
// buffers with a barrier between sweeps, and writes the tile's interior.  A
// cell at the tile's edge has no neighbour beyond it and takes itself in
// its place, as the reference's tiles do; that error travels one cell a
// sweep, so the interior, `this` cells in, is exact.  A neighbour outside
// the domain is the cell itself at every sweep, which is the oracle's
// edge-replicated boundary, so the interior is exact over the whole domain
// and not only on the reference's central crop.  The power tile is staged
// in shared memory beside the two buffers (PSMEM, power_smem = 1: the
// reference's keep_power_vmem), or read from device memory every sweep.
// The blocks run in row-major or column-major raster (grid_order).  The
// sweep loop runs in chunks of U sweeps unrolled (unroll_t, snapped down to
// a divisor of the launch's sweep count, as the reference snaps it).  The C
// launcher issues all ceil(n / tt) launches on the stream itself, so one
// call from Python is one host round trip; the state lives in f32 between
// launches, alternating between `out` and a scratch buffer so that the last
// launch writes `out`.
//
// acc_dtype bf16 follows the reference exactly: temperature, power and the
// five constants rounded to bf16 at each launch, and every operation of the
// sweep rounded to bf16 in the order the expression parses, each from one
// f32 operation (__fmul_rn, __fadd_rn, __fsub_rn: nvcc contracts none into
// an FMA), as PyTorch's and XLA's bf16 ops compute them.  acc_dtype f32 lets
// nvcc fuse multiply-adds.
//
// Bound at the default shape (3248 x 3248 padded domain, 600 sweeps; H100
// SXM data sheet): each cell update is 15 f32 operations, 600 x 3248^2 x
// 15 = 95 GFLOP, 1.42 ms at 67 TFLOP/s; reading temp and power and writing
// out once is 127 MB, 0.04 ms at 3.35 TB/s.  So it is bound by its
// operations.  A launch with tt sweeps re-reads the domain (and computes
// the halo again): small tt pays device memory, large tt and small tiles
// pay halo work, which is the landscape the paper reports.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_UNROLL = 10;

struct Consts {
  float step, rx, ry, rz, amb;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// One cell's update.  In bf16 every operation is rounded, left to right as
// the reference's expression parses; in f32 nvcc may fuse.
template <int ACC_BF16>
__device__ __forceinline__ float sweep_cell(float t, float p, float up, float down, float left,
                                            float right, const Consts& k) {
  if (ACC_BF16) {
    const float t2 = bf16_round(__fmul_rn(2.f, t));
    float a = bf16_round(__fadd_rn(up, down));
    a = bf16_round(__fsub_rn(a, t2));
    a = bf16_round(__fmul_rn(k.ry, a));
    float s = bf16_round(__fadd_rn(p, a));
    float b = bf16_round(__fadd_rn(left, right));
    b = bf16_round(__fsub_rn(b, t2));
    b = bf16_round(__fmul_rn(k.rx, b));
    s = bf16_round(__fadd_rn(s, b));
    float c = bf16_round(__fsub_rn(k.amb, t));
    c = bf16_round(__fmul_rn(k.rz, c));
    s = bf16_round(__fadd_rn(s, c));
    s = bf16_round(__fmul_rn(k.step, s));
    return bf16_round(__fadd_rn(t, s));
  } else {
    return t + k.step * (p + k.ry * (up + down - 2.f * t) + k.rx * (left + right - 2.f * t) +
                         k.rz * (k.amb - t));
  }
}

template <int U, int ACC_BF16, int PSMEM>
__global__ void __launch_bounds__(MAX_THREADS, 1)
hotspot_kernel(const float* __restrict__ tin, const float* __restrict__ pw,
               float* __restrict__ tout, int h, int w, int bh, int bw, int sweeps, int gh,
               int gw, int col_major, Consts k) {
  extern __shared__ float smem[];
  const int th = bh + 2 * sweeps, tw = bw + 2 * sweeps, cells = th * tw;
  float* src = smem;
  float* dst = smem + cells;
  float* sp = smem + 2 * cells;  // th x tw, with PSMEM
  if (ACC_BF16) {
    k.step = bf16_round(k.step);
    k.rx = bf16_round(k.rx);
    k.ry = bf16_round(k.ry);
    k.rz = bf16_round(k.rz);
    k.amb = bf16_round(k.amb);
  }
  const int b = blockIdx.x;
  const int by = col_major ? b % gh : b / gw;
  const int bx = col_major ? b / gh : b % gw;
  const int gy0 = by * bh - sweeps, gx0 = bx * bw - sweeps;  // the tile's (0, 0)

  for (int ly = threadIdx.y; ly < th; ly += blockDim.y) {
    const int gy = clampi(gy0 + ly, 0, h - 1);
    for (int lx = threadIdx.x; lx < tw; lx += blockDim.x) {
      const size_t g = static_cast<size_t>(gy) * w + clampi(gx0 + lx, 0, w - 1);
      const float t = tin[g];
      src[ly * tw + lx] = ACC_BF16 ? bf16_round(t) : t;
      if (PSMEM) {
        const float p = pw[g];
        sp[ly * tw + lx] = ACC_BF16 ? bf16_round(p) : p;
      }
    }
  }
  __syncthreads();

#pragma unroll 1
  for (int c = 0; c < sweeps / U; ++c) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      for (int ly = threadIdx.y; ly < th; ly += blockDim.y) {
        const int gy = gy0 + ly;
        const bool top = ly == 0 || gy <= 0, bottom = ly == th - 1 || gy >= h - 1;
        for (int lx = threadIdx.x; lx < tw; lx += blockDim.x) {
          const int gx = gx0 + lx, i = ly * tw + lx;
          const float t = src[i];
          const float up = top ? t : src[i - tw];
          const float down = bottom ? t : src[i + tw];
          const float left = (lx == 0 || gx <= 0) ? t : src[i - 1];
          const float right = (lx == tw - 1 || gx >= w - 1) ? t : src[i + 1];
          float p;
          if (PSMEM) {
            p = sp[i];
          } else {
            p = pw[static_cast<size_t>(clampi(gy, 0, h - 1)) * w + clampi(gx, 0, w - 1)];
            if (ACC_BF16) p = bf16_round(p);
          }
          dst[i] = sweep_cell<ACC_BF16>(t, p, up, down, left, right, k);
        }
      }
      __syncthreads();
      float* tmp = src;
      src = dst;
      dst = tmp;
    }
  }

  for (int oy = threadIdx.y; oy < bh; oy += blockDim.y) {
    const int gy = by * bh + oy;
    if (gy >= h) break;
    for (int ox = threadIdx.x; ox < bw; ox += blockDim.x) {
      const int gx = bx * bw + ox;
      if (gx < w) tout[static_cast<size_t>(gy) * w + gx] = src[(oy + sweeps) * tw + ox + sweeps];
    }
  }
}

template <int U, int ACC_BF16, int PSMEM>
int launch_one(const float* tin, const float* pw, float* tout, int h, int w, int bh, int bw,
               int sweeps, int col_major, const Consts& k, cudaStream_t stream) {
  auto kern = hotspot_kernel<U, ACC_BF16, PSMEM>;
  const int th = bh + 2 * sweeps, tw = bw + 2 * sweeps;
  const int smem = (2 + PSMEM) * th * tw * static_cast<int>(sizeof(float));
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const int gh = (h + bh - 1) / bh, gw = (w + bw - 1) / bw;
  const int bdx = bw < 128 ? bw : 128;
  const int bdy = bh < MAX_THREADS / bdx ? bh : MAX_THREADS / bdx;
  kern<<<gh * gw, dim3(bdx, bdy), smem, stream>>>(tin, pw, tout, h, w, bh, bw, sweeps, gh, gw,
                                                  col_major, k);
  return cudaGetLastError();
}

template <int U, int ACC_BF16, int PSMEM>
int attributes_of(int* regs, int* local_bytes, int* max_threads) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, hotspot_kernel<U, ACC_BF16, PSMEM>);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *max_threads = attr.maxThreadsPerBlock;
  return cudaSuccess;
}

}  // namespace

#define HOT_PS(X, U_, A_) X(U_, A_, 0) X(U_, A_, 1)
#define HOT_ACC(X, U_) HOT_PS(X, U_, 0) HOT_PS(X, U_, 1)
#define HOT_TILES(X)                                                                 \
  HOT_ACC(X, 1) HOT_ACC(X, 2) HOT_ACC(X, 3) HOT_ACC(X, 4) HOT_ACC(X, 5) HOT_ACC(X, 6) \
  HOT_ACC(X, 7) HOT_ACC(X, 8) HOT_ACC(X, 9) HOT_ACC(X, 10)

extern "C" {

// Advance `temp` n_sweeps sweeps into `out`, ceil(n_sweeps / tt) launches on
// `stream`; scratch is a second (h, w) f32 buffer (temp is not written).
// Returns the cudaError_t of the first launch that failed (0 on success).
// block_h, block_w >= 1; 1 <= unroll_t <= 10, snapped down per launch to a
// divisor of its sweep count.
int hotspot_launch(const void* temp, const void* power, void* out, void* scratch, int h, int w,
                   int n_sweeps, int tt, int block_h, int block_w, int unroll_t, int acc_bf16,
                   int power_smem, int col_major, float step, float rx, float ry, float rz,
                   float amb, void* stream) {
  if (h < 1 || w < 1 || n_sweeps < 0 || tt < 1 || block_h < 1 || block_w < 1 || unroll_t < 1 ||
      unroll_t > MAX_UNROLL)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pw = static_cast<const float*>(power);
  float* bufs[2] = {static_cast<float*>(out), static_cast<float*>(scratch)};
  const Consts k{step, rx, ry, rz, amb};
  if (n_sweeps == 0)
    return cudaMemcpyAsync(out, temp, static_cast<size_t>(h) * w * sizeof(float),
                           cudaMemcpyDeviceToDevice, st);
  const int launches = (n_sweeps + tt - 1) / tt;
  const float* src = static_cast<const float*>(temp);
  int done = 0;
  for (int l = 0; l < launches; ++l) {
    const int sweeps = n_sweeps - done < tt ? n_sweeps - done : tt;
    int u = unroll_t < sweeps ? unroll_t : sweeps;
    while (sweeps % u) --u;
    float* dst = bufs[(launches - 1 - l) % 2];
    int err = cudaErrorInvalidValue;
#define HOT_DISPATCH(U_, A_, P_)                           \
  if (u == U_ && acc_bf16 == A_ && power_smem == P_)      \
    err = launch_one<U_, A_, P_>(src, pw, dst, h, w, block_h, block_w, sweeps, col_major, k, st);
    HOT_TILES(HOT_DISPATCH)
#undef HOT_DISPATCH
    if (err != cudaSuccess) return err;
    src = dst;
    done += sweeps;
  }
  return cudaSuccess;
}

// Registers, local (spill) bytes and the most threads a block may have, of
// one compiled tile.
int hotspot_attributes(int unroll_t, int acc_bf16, int power_smem, int* regs, int* local_bytes,
                       int* max_threads) {
#define HOT_ATTRS(U_, A_, P_)                                  \
  if (unroll_t == U_ && acc_bf16 == A_ && power_smem == P_) \
    return attributes_of<U_, A_, P_>(regs, local_bytes, max_threads);
  HOT_TILES(HOT_ATTRS)
#undef HOT_ATTRS
  return cudaErrorInvalidValue;
}

const char* hotspot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
