// Point in polygon for Hopper (sm_90a): the even-odd crossing test of every
// point against every edge of one polygon, f32 in, int32 out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pnpoly/kernel.py::pnpoly
// (its body _pnpoly_kernel, edges from _edge_data).  Same function, same
// tunables; the blocks are Hopper's.
//
//   pts (2, N) f32 as two rows (x, then y), or (N, 2) as float2 pairs;
//   poly (2, V) f32, vertices in order, the last joined to the first;
//   out (N,) int32: 1 where the point is inside.
//
// Design.  A thread owns PPT points, blockDim.x apart so a warp's loads are
// coalesced; a block owns block_points = blockDim.x * PPT of them, with
// blockDim.x = min(block_points, 512) (so PPT > 1 only above 512 points,
// and 128 registers a thread keep every tile free of spills).  The
// vertices live in __constant__ memory, copied there on the launch's
// stream: every thread reads the same edge at the same time, so each read
// is a broadcast.  An edge's slope is (x2 - x1) / (y2 - y1), with 1 for a
// horizontal edge, computed per point and edge, or with precompute once
// per block into shared memory.  The edge loop runs in chunks of UNROLL
// unrolled edges, then the remainder, as the reference's fori_loop does.
//
// Exact output.  The answer is an integer and is held exactly against the
// plain PyTorch version, so each step rounds as PyTorch's separate ops do:
// the crossing is slope * (py - y1) + x1 with __fmul_rn / __fadd_rn, which
// nvcc does not contract into one FMA, and the slope is an IEEE division.
//
// between_method (BETWEEN, one nvcc build each) and use_method (USE) are
// the reference's twelve variants:
//   between 0  (y1 > py) != (y2 > py)
//           1  (y1 - py) * (y2 - py) < 0, and where that product is 0 (a
//              vertex exactly at the point's height, or underflow) the
//              test of variant 0.  The reference stops at the product, so
//              a point level with a vertex whose edges run on up and down
//              counts no crossing there, where the other variants and the
//              reference's own oracle count one (ROADMAP, queue 3).
//           2  |int(y1 > py) - int(y2 > py)| == 1
//           3  min(y1, y2) <= py < max(y1, y2)
//   use     0  a boolean parity, flipped at each crossing
//           1  a crossing count, its parity at the end
//           2  a float sign, multiplied by -1 at each crossing
//
// Bound at the default shape (N = 2 000 000, V = 600; H100 SXM data sheet):
// 1.2e9 point-edge pairs at about 7 operations each take 0.13 ms at 67
// TFLOP/s f32; the 24 MB of points and output take 0.007 ms at 3.35 TB/s.
// So the kernel is bound by its operations; the constant-cache reads of the
// edge and, without precompute, a division per pair come on top of them.

#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(PNP_BETWEEN)
#error "build with -DPNP_BETWEEN=0|1|2|3"
#endif

namespace {

constexpr int MAX_V = 4096;
constexpr int MAX_THREADS = 512;
__constant__ float c_poly[2 * MAX_V];  // x of the V vertices, then their y

__device__ __forceinline__ float slope_of(float x1, float y1, float x2, float y2) {
  const float den = y2 - y1;
  return __fdiv_rn(x2 - x1, den == 0.f ? 1.f : den);
}

__device__ __forceinline__ bool between(float y1, float y2, float py) {
  const bool gt1 = y1 > py, gt2 = y2 > py;
#if PNP_BETWEEN == 0
  return gt1 != gt2;
#elif PNP_BETWEEN == 1
  const float p = __fmul_rn(y1 - py, y2 - py);
  return p < 0.f || (p == 0.f && gt1 != gt2);
#elif PNP_BETWEEN == 2
  return abs(static_cast<int>(gt1) - static_cast<int>(gt2)) == 1;
#else
  return fminf(y1, y2) <= py && py < fmaxf(y1, y2);
#endif
}

template <int USE>
struct Acc;
template <>
struct Acc<0> {
  bool a = false;
  __device__ void cross() { a = !a; }
  __device__ int inside() const { return a; }
};
template <>
struct Acc<1> {
  int a = 0;
  __device__ void cross() { ++a; }
  __device__ int inside() const { return a % 2; }
};
template <>
struct Acc<2> {
  float a = 1.f;
  __device__ void cross() { a *= -1.f; }
  __device__ int inside() const { return a < 0.f; }
};

template <int USE, int UNROLL, int PRE, int PPT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
pnp_kernel(const float* __restrict__ pts, int* __restrict__ out, int n, int v, int aos) {
  extern __shared__ float slopes[];  // v of them, with PRE
  if (PRE) {
    for (int e = threadIdx.x; e < v; e += blockDim.x) {
      const int en = e + 1 == v ? 0 : e + 1;
      slopes[e] = slope_of(c_poly[e], c_poly[v + e], c_poly[en], c_poly[v + en]);
    }
    __syncthreads();
  }
  const int first = blockIdx.x * blockDim.x * PPT + threadIdx.x;
  float px[PPT], py[PPT];
  Acc<USE> acc[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int i = first + p * blockDim.x;
    px[p] = py[p] = 0.f;
    if (i < n) {
      if (aos) {
        const float2 q = reinterpret_cast<const float2*>(pts)[i];
        px[p] = q.x;
        py[p] = q.y;
      } else {
        px[p] = pts[i];
        py[p] = pts[n + i];
      }
    }
  }

  auto edge = [&](int e) {
    const int en = e + 1 == v ? 0 : e + 1;
    const float x1 = c_poly[e], y1 = c_poly[v + e];
    const float x2 = c_poly[en], y2 = c_poly[v + en];
    const float slope = PRE ? slopes[e] : slope_of(x1, y1, x2, y2);
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const float xint = __fadd_rn(__fmul_rn(slope, py[p] - y1), x1);
      if (between(y1, y2, py[p]) && px[p] < xint) acc[p].cross();
    }
  };
  const int chunks = v / UNROLL;
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) edge(c * UNROLL + u);
  }
#pragma unroll 1
  for (int e = chunks * UNROLL; e < v; ++e) edge(e);

#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int i = first + p * blockDim.x;
    if (i < n) out[i] = acc[p].inside();
  }
}

template <int USE, int UNROLL, int PRE, int PPT>
int launch_tile(const float* pts, int* out, int n, int v, int threads, int aos,
                cudaStream_t stream) {
  const int per_block = threads * PPT;
  const size_t smem = PRE ? static_cast<size_t>(v) * sizeof(float) : 0;
  pnp_kernel<USE, UNROLL, PRE, PPT>
      <<<(n + per_block - 1) / per_block, threads, smem, stream>>>(pts, out, n, v, aos);
  return cudaGetLastError();
}

template <int USE, int UNROLL, int PRE, int PPT>
int tile_attributes(int* regs, int* local_bytes, int* max_threads) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, pnp_kernel<USE, UNROLL, PRE, PPT>);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *max_threads = attr.maxThreadsPerBlock;
  return cudaSuccess;
}

}  // namespace

#define PNP_UNROLLS(X, U_, P_, T_) \
  X(U_, 1, P_, T_) X(U_, 2, P_, T_) X(U_, 3, P_, T_) X(U_, 4, P_, T_) X(U_, 6, P_, T_) X(U_, 8, P_, T_)
#define PNP_PPTS(X, U_, P_) \
  PNP_UNROLLS(X, U_, P_, 1) PNP_UNROLLS(X, U_, P_, 2) PNP_UNROLLS(X, U_, P_, 4) PNP_UNROLLS(X, U_, P_, 8)
#define PNP_PRES(X, U_) PNP_PPTS(X, U_, 0) PNP_PPTS(X, U_, 1)
#define PNP_TILES(X) PNP_PRES(X, 0) PNP_PRES(X, 1) PNP_PRES(X, 2)

extern "C" {

// Launch on `stream`; returns the cudaError_t of the copy of the vertices or
// of the launch (0 on success).  block_points is a power of two from 32 to
// 4096: min(block_points, MAX_THREADS) threads of block_points / threads
// points each.  Launches on one stream at a time: the vertices' copy and
// the kernel are ordered on `stream` only.
int pnp_launch(const void* pts, const void* poly, void* out, int n, int v, int block_points,
               int use, int unroll, int pre, int aos, void* stream) {
  if (n < 1 || v < 1 || v > MAX_V || block_points < 32 || block_points > 4096 ||
      (block_points & (block_points - 1)) != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemcpyToSymbolAsync(c_poly, poly, 2 * v * sizeof(float), 0,
                                                cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return e;
  const int threads = block_points < MAX_THREADS ? block_points : MAX_THREADS;
  const int ppt = block_points / threads;
  const float* p = static_cast<const float*>(pts);
  int* o = static_cast<int*>(out);
#define PNP_DISPATCH(U_, R_, P_, T_)                                 \
  if (use == U_ && unroll == R_ && pre == P_ && ppt == T_)           \
    return launch_tile<U_, R_, P_, T_>(p, o, n, v, threads, aos, st);
  PNP_TILES(PNP_DISPATCH)
#undef PNP_DISPATCH
  return cudaErrorInvalidValue;
}

// Registers, local (spill) bytes and the most threads a block may have, of
// one compiled tile.
int pnp_attributes(int use, int unroll, int pre, int ppt, int* regs, int* local_bytes,
                   int* max_threads) {
#define PNP_ATTRS(U_, R_, P_, T_)                                  \
  if (use == U_ && unroll == R_ && pre == P_ && ppt == T_)         \
    return tile_attributes<U_, R_, P_, T_>(regs, local_bytes, max_threads);
  PNP_TILES(PNP_ATTRS)
#undef PNP_ATTRS
  return cudaErrorInvalidValue;
}

const char* pnp_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
