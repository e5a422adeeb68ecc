// Tunable bf16 GEMM for Hopper (sm_90a):  out = alpha * A @ B + beta * C.
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul/kernel.py::gemm
// (its body _gemm_kernel).  Same function, same tunables where the meaning
// carries; the blocks are Hopper's, not the TPU's.
//
//   A (M, K) bf16 row-major.  B (K, N) for rhs_layout "kn", (N, K) for "nk".
//   C and out (M, N) bf16.  With split_k > 1 the grid's y axis is the k
//   slice: slice s computes bf16(alpha * A[:, s] @ B[s]) into out[s] with
//   beta = 0, and the caller sums the slices in f32 (as the JAX package
//   leaves that sum to XLA).
//
// Design.  One block computes one (BM, BN) output tile.  A and B tiles of
// depth BK are staged in shared memory by cp.async, two stages deep, so the
// next k block loads while this one is multiplied.  Each k block is
// consumed as unroll_k sub-dots of depth BK / unroll_k: each sub-dot's
// slice of the tiles is its own cp.async group, and the warps start on
// sub-dot u as soon as its group has landed (the reference's unroll_k is
// the same issue-granularity knob).  The warps (2 x WARPS/2) each own a
// (BM/2, BN/(WARPS/2)) slab of the tile as 16x16 bf16 WMMA fragments
// (mma.sync on the tensor cores) with f32 accumulators.  With
// acc_bf16 the accumulators are rounded to bf16 at the end of every k
// block, as the reference stores its accumulator in acc_dtype between k
// blocks.  The epilogue goes through a 1 KiB per-warp f32 scratch tile,
// applies alpha and beta*C in f32 and writes bf16 with 16-byte stores.
//
// Tile shapes, the warp count and the layout are template parameters; the
// split, grid order, alpha, beta and accumulator rounding are runtime
// arguments, and unroll_k (1 or 2) picks one of two bodies compiled into
// each kernel, so the menu compiles in a few dozen instantiations.
// Each source build holds one (layout, BK) pair: -DGEMM_NK=0|1
// -DGEMM_BK=32|64, and the four builds run in parallel.
//
// Bound at M = N = K = 4096 (H100 SXM data sheet): 2 * 4096^3 = 137.4 GFLOP
// at 989 TFLOP/s dense bf16 is 0.139 ms; the bytes, A, B, C read once and
// out written once (4 x 32 MiB) at 3.35 TB/s, take 0.040 ms.  So the kernel
// is compute-bound, and what it lacks is Hopper's own path to the tensor
// cores: a wgmma + TMA redesign (warp-specialised producer, mbarrier ring,
// persistent blocks) is later work; this version is the simple, right one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

#if !defined(GEMM_NK) || !defined(GEMM_BK)
#error "build with -DGEMM_NK=0|1 -DGEMM_BK=32|64"
#endif

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int PAD = 8;        // bf16 of padding per shared-memory row (16 B)
constexpr int STAGES = 2;
constexpr int MAX_ACC = 128;  // f32 accumulators a thread may hold

template <int BM, int BN, int BK, int WARPS, bool NK>
struct Tile {
  static constexpr int THREADS = WARPS * 32;
  static constexpr int WARPS_M = 2;
  static constexpr int WARPS_N = WARPS / 2;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int FM = WM / 16;
  static constexpr int FN = WN / 16;
  static constexpr int A_LD = BK + PAD;            // A tile: BM rows of BK
  static constexpr int B_ROWS = NK ? BN : BK;      // B tile as stored
  static constexpr int B_LD = (NK ? BK : BN) + PAD;
  static constexpr int A_ELEMS = BM * A_LD;
  static constexpr int STAGE_ELEMS = A_ELEMS + B_ROWS * B_LD;
  static constexpr int SMEM = STAGES * STAGE_ELEMS * 2 + WARPS * 256 * 4;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile of whole fragments");
  static_assert(BM * BN / THREADS <= MAX_ACC, "accumulators exceed budget");
};

// Issue the copies of sub-dot u (k columns [u*STEP, (u+1)*STEP) of the k
// block at k0) into one stage of shared memory.
template <int BM, int BN, int BK, int WARPS, bool NK, int STEP>
__device__ __forceinline__ void load_subdot(bf16* stage, const bf16* a, const bf16* b,
                                            int lda, int ldb, int m0, int n0, int k0,
                                            int u) {
  using T = Tile<BM, BN, BK, WARPS, NK>;
  bf16* as = stage;
  bf16* bs = stage + T::A_ELEMS;
  constexpr int chunks = STEP / 8;  // 16-byte chunks per row of the sub-dot
  const int col0 = u * STEP;
  for (int c = threadIdx.x; c < BM * chunks; c += T::THREADS) {
    const int r = c / chunks, col = col0 + (c % chunks) * 8;
    cp_async16(as + r * T::A_LD + col, a + (size_t)(m0 + r) * lda + k0 + col);
  }
  if (NK) {  // B stored (N, K): BN rows, the sub-dot's k columns
    for (int c = threadIdx.x; c < BN * chunks; c += T::THREADS) {
      const int r = c / chunks, col = col0 + (c % chunks) * 8;
      cp_async16(bs + r * T::B_LD + col, b + (size_t)(n0 + r) * ldb + k0 + col);
    }
  } else {   // B stored (K, N): the sub-dot's k rows, BN columns
    constexpr int row_chunks = BN / 8;
    for (int c = threadIdx.x; c < STEP * row_chunks; c += T::THREADS) {
      const int r = col0 + c / row_chunks, col = (c % row_chunks) * 8;
      cp_async16(bs + r * T::B_LD + col, b + (size_t)(k0 + r) * ldb + n0 + col);
    }
  }
}

// The whole kernel for U sub-dots per k block.
template <int BM, int BN, int BK, int WARPS, bool NK, int U>
__device__ __forceinline__ void gemm_tile(const bf16* __restrict__ A,
                                          const bf16* __restrict__ B,
                                          const bf16* __restrict__ C, bf16* __restrict__ Out,
                                          int M, int N, int K, int k_slice, int acc_bf16,
                                          int order_nm, float alpha, float beta) {
  using T = Tile<BM, BN, BK, WARPS, NK>;
  constexpr int STEP = BK / U;
  static_assert(STEP % 16 == 0, "a sub-dot is whole 16-deep fragments");
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                               typename std::conditional<NK, wmma::col_major,
                                                         wmma::row_major>::type>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  float* scratch = reinterpret_cast<float*>(smem_raw + STAGES * T::STAGE_ELEMS * 2);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  // block raster: "mn" walks n fastest, "nm" walks m fastest
  const int gm = M / BM, gn = N / BN;
  const int bi = order_nm ? blockIdx.x % gm : blockIdx.x / gn;
  const int bj = order_nm ? blockIdx.x / gm : blockIdx.x % gn;
  const int m0 = bi * BM, n0 = bj * BN;
  const int s = blockIdx.y;  // k slice
  const int lda = K, ldb = NK ? K : N;
  const bf16* a = A + (size_t)s * k_slice;
  const bf16* b = NK ? B + (size_t)s * k_slice : B + (size_t)s * k_slice * N;
  bf16* out = Out + (size_t)s * M * N;

  FragC acc[T::FM][T::FN];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nkb = k_slice / BK;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    load_subdot<BM, BN, BK, WARPS, NK, STEP>(smem, a, b, lda, ldb, m0, n0, 0, u);
    cp_async_commit();
  }
  for (int kb = 0; kb < nkb; ++kb) {
    const int cur = kb & 1;
    // prefetch the next k block; empty groups past the end keep the count
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (kb + 1 < nkb)
        load_subdot<BM, BN, BK, WARPS, NK, STEP>(smem + (cur ^ 1) * T::STAGE_ELEMS, a, b,
                                                 lda, ldb, m0, n0, (kb + 1) * BK, u);
      cp_async_commit();
    }
    const bf16* as = smem + cur * T::STAGE_ELEMS;
    const bf16* bs = as + T::A_ELEMS;
    // Not unrolled: one 16-deep step's fragments are live at a time.  Fully
    // unrolled, ptxas hoists every step's fragment loads and spills the
    // tiles holding 128 accumulators a thread.
#pragma unroll 1
    for (int kc = 0; kc < BK / 16; ++kc) {
      if ((kc * 16) % STEP == 0) {  // first fragment of sub-dot u
        const int u = kc * 16 / STEP;
        cp_async_wait(2 * U - 1 - u);  // this block's groups <= u have landed
        __syncthreads();
      }
      FragA fa[T::FM];
      FragB fb[T::FN];
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * T::WM + i * 16) * T::A_LD + kc * 16, T::A_LD);
#pragma unroll
      for (int j = 0; j < T::FN; ++j) {
        const int n = wn * T::WN + j * 16;
        wmma::load_matrix_sync(fb[j], NK ? bs + n * T::B_LD + kc * 16
                                         : bs + kc * 16 * T::B_LD + n, T::B_LD);
      }
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
#pragma unroll
        for (int j = 0; j < T::FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (acc_bf16) {  // the accumulator is stored in bf16 between k blocks
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
#pragma unroll
        for (int j = 0; j < T::FN; ++j)
#pragma unroll
          for (int e = 0; e < acc[i][j].num_elements; ++e)
            acc[i][j].x[e] = __bfloat162float(__float2bfloat16(acc[i][j].x[e]));
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

  // epilogue: fragment -> per-warp f32 scratch -> alpha, beta*C -> bf16
  float* scr = scratch + warp * 256;
  const int r = lane / 2, c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < T::FM; ++i) {
#pragma unroll
    for (int j = 0; j < T::FN; ++j) {
      wmma::store_matrix_sync(scr, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const size_t off = (size_t)(m0 + wm * T::WM + i * 16 + r) * N + n0 + wn * T::WN + j * 16 + c0;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __fmul_rn(alpha, scr[r * 16 + c0 + e]);
      if (beta != 0.0f) {
        const uint4 cw = *reinterpret_cast<const uint4*>(C + off);
        const uint32_t w[4] = {cw.x, cw.y, cw.z, cw.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[2 * e] = __fadd_rn(v[2 * e], __fmul_rn(beta, bf16_lo(w[e])));
          v[2 * e + 1] = __fadd_rn(v[2 * e + 1], __fmul_rn(beta, bf16_hi(w[e])));
        }
      }
      *reinterpret_cast<uint4*>(out + off) =
          make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                     pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
      __syncwarp();
    }
  }
}

// Launch bounds ask for one resident block per SM: without that minimum,
// ptxas held one small tile to 80 registers and spilled 4 bytes.
template <int BM, int BN, int BK, int WARPS, bool NK>
__global__ void __launch_bounds__(WARPS * 32, 1)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
            const bf16* __restrict__ C, bf16* __restrict__ Out, int M, int N,
            int K, int k_slice, int acc_bf16, int unroll_k, int order_nm,
            float alpha, float beta) {
  if (unroll_k == 2)
    gemm_tile<BM, BN, BK, WARPS, NK, 2>(A, B, C, Out, M, N, K, k_slice, acc_bf16,
                                        order_nm, alpha, beta);
  else
    gemm_tile<BM, BN, BK, WARPS, NK, 1>(A, B, C, Out, M, N, K, k_slice, acc_bf16,
                                        order_nm, alpha, beta);
}

template <int BM, int BN, int WARPS>
constexpr bool in_menu() {
  return BM * BN / (WARPS * 32) <= MAX_ACC;
}

template <int BM, int BN, int WARPS>
int launch_tile(const void* a, const void* b, const void* c, void* out, int m, int n,
                int k, int split_k, int acc_bf16, int unroll_k, int order_nm, float alpha,
                float beta, cudaStream_t stream) {
  if constexpr (!in_menu<BM, BN, WARPS>()) {
    return cudaErrorInvalidValue;
  } else {
    using T = Tile<BM, BN, GEMM_BK, WARPS, GEMM_NK != 0>;
    auto kern = gemm_kernel<BM, BN, GEMM_BK, WARPS, GEMM_NK != 0>;
    static bool smem_set = false;
    if (!smem_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
      if (e != cudaSuccess) return e;
      smem_set = true;
    }
    const dim3 grid((m / BM) * (n / BN), split_k);
    kern<<<grid, T::THREADS, T::SMEM, stream>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b),
        static_cast<const bf16*>(c), static_cast<bf16*>(out), m, n, k, k / split_k,
        acc_bf16, unroll_k, order_nm, alpha, beta);
    return cudaGetLastError();
  }
}

template <int BM, int BN, int WARPS>
int tile_attributes(int* regs, int* local_bytes, int* smem_bytes) {
  if constexpr (!in_menu<BM, BN, WARPS>()) {
    return cudaErrorInvalidValue;
  } else {
    cudaFuncAttributes attr;
    const cudaError_t e =
        cudaFuncGetAttributes(&attr, gemm_kernel<BM, BN, GEMM_BK, WARPS, GEMM_NK != 0>);
    if (e != cudaSuccess) return e;
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    *smem_bytes = Tile<BM, BN, GEMM_BK, WARPS, GEMM_NK != 0>::SMEM;
    return cudaSuccess;
  }
}

}  // namespace

#define GEMM_TILES(X)                                                            \
  X(64, 64, 4) X(64, 64, 8) X(64, 128, 4) X(64, 128, 8) X(64, 256, 4)            \
  X(64, 256, 8) X(128, 64, 4) X(128, 64, 8) X(128, 128, 4) X(128, 128, 8)        \
  X(128, 256, 4) X(128, 256, 8) X(256, 64, 4) X(256, 64, 8) X(256, 128, 4)       \
  X(256, 128, 8) X(256, 256, 4) X(256, 256, 8)

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// k is the full depth; the wrapper checks shapes before it gets here.
int gemm_launch(const void* a, const void* b, const void* c, void* out, int m, int n,
                int k, int split_k, int block_m, int block_n, int warps, int acc_bf16,
                int unroll_k, int order_nm, float alpha, float beta, void* stream) {
  if (unroll_k < 1 || unroll_k > 2 || GEMM_BK % (16 * unroll_k) != 0 || split_k < 1 ||
      m % block_m != 0 || n % block_n != 0 || k % split_k != 0 ||
      k / split_k < GEMM_BK || (k / split_k) % GEMM_BK != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GEMM_DISPATCH(BM_, BN_, W_)                                                  \
  if (block_m == BM_ && block_n == BN_ && warps == W_)                               \
    return launch_tile<BM_, BN_, W_>(a, b, c, out, m, n, k, split_k, acc_bf16,       \
                                     unroll_k, order_nm, alpha, beta, st);
  GEMM_TILES(GEMM_DISPATCH)
#undef GEMM_DISPATCH
  return cudaErrorInvalidValue;
}

// Registers, local (spill) bytes and dynamic shared memory of one tile.
int gemm_attributes(int block_m, int block_n, int warps, int* regs, int* local_bytes,
                    int* smem_bytes) {
#define GEMM_ATTRS(BM_, BN_, W_)                       \
  if (block_m == BM_ && block_n == BN_ && warps == W_) \
    return tile_attributes<BM_, BN_, W_>(regs, local_bytes, smem_bytes);
  GEMM_TILES(GEMM_ATTRS)
#undef GEMM_ATTRS
  return cudaErrorInvalidValue;
}

const char* gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
