// Tunable bf16 GEMM for Hopper (sm_90a):  out = alpha * A @ B + beta * C.
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul/kernel.py:71
// gemm (its body _gemm_kernel, :29).  Same function, same tunables where the
// meaning carries; the blocks are Hopper's, not the TPU's.
//
//   A (M, K) bf16 row-major.  B (K, N) for rhs_layout "kn", (N, K) for "nk".
//   C and out (M, N) bf16.  With split_k > 1 the grid's y axis is the k
//   slice: slice s computes bf16(alpha * A[:, s] @ B[s]) into out[s] with
//   beta = 0, and the caller sums the slices in f32 (as the JAX package
//   leaves that sum to XLA).
//
// Bound at M = N = K = 4096 (H100 SXM data sheet): 2 * 4096^3 = 137.4 GFLOP
// at 989 TFLOP/s dense bf16 is 0.139 ms; the bytes, A, B, C read once and
// out written once (4 x 32 MiB) at 3.35 TB/s, take 0.040 ms.  So the kernel
// is bound by the tensor cores, which on Hopper run at full rate only
// through wgmma fed from shared memory.
//
// Design (the building blocks are in hopper.cuh).  One block computes one
// (BM, BN) output tile; blocks are not persistent.  Warp-specialised: a
// producer warpgroup gives up its registers (setmaxnreg.dec) and one of its
// threads keeps TMA loads of the A and B tiles in flight into a ring of
// `stages` shared-memory buffers (a runtime argument), each guarded by a
// "full" and an "empty" mbarrier.  One or two consumer warpgroups (warps 4
// or 8) take the registers (setmaxnreg.inc), wait on "full", issue
// m64nNk16 wgmmas straight from shared memory into f32 accumulators in
// registers, and arrive on "empty" once their wgmmas on that stage have
// retired; no __syncthreads() in the main loop.  Two consumer warpgroups
// split the tile's rows when BM >= 128, else its columns.
//   A and B under "nk" are K-major, wgmma's native form: one TMA box of
// BK-wide rows, swizzled 128 B (BK 64) or 64 B (BK 32).  B under "kn" is
// MN-major: BN / 64 boxes of 64 columns by BK rows, swizzled 128 B, read
// with the transposed-B immediate and the MN-major descriptor.
//   unroll_k is the issue granularity: a k block's wgmmas go out as
// unroll_k commit groups of BK / unroll_k depth each.  With acc_bf16 the
// consumer waits for a k block's wgmmas and rounds the accumulators to bf16
// in place, as the reference stores its accumulator in acc_dtype between k
// blocks; this serialises the wgmmas per k block, for those configs only.
// The epilogue works on the accumulator fragment in registers: alpha, then
// beta * C read as bf16 pairs, with __fmul_rn / __fadd_rn (no contraction
// into FMAs, so it rounds as the plain version does), stored as bf16 pairs.
//
// Left for later: persistent blocks, so that one tile's epilogue overlaps
// the next one's loads and the last wave is not partly idle, and clusters
// with TMA multicast of the shared A and B tiles.
//
// Each source build holds one (layout, BK) pair: -DGEMM_NK=0|1
// -DGEMM_BK=32|64; the tiles of GEMM_TILES are its instantiations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

#if !defined(GEMM_NK) || !defined(GEMM_BK)
#error "build with -DGEMM_NK=0|1 -DGEMM_BK=32|64"
#endif

typedef __nv_bfloat16 bf16;
using namespace hopper;

namespace {

constexpr bool NK = GEMM_NK != 0;
constexpr int BK = GEMM_BK;
constexpr int K_ROW = BK * 2;       // bytes of a K-major tile's row: its swizzle
constexpr int KN_COLS = 64;         // columns of one "kn" B box (128 B rows)
constexpr int MAX_ACC = 128;        // f32 accumulators a consumer thread may hold
constexpr int MAX_STAGES = 4;
constexpr int ALIGN = 1024;         // a 128 B swizzle repeats every 1024 B
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

template <int BM, int BN, int CW>
struct Tile {
  static constexpr int CONSUMERS = CW * 128;
  static constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
  static constexpr bool SPLIT_M = CW == 2 && BM >= 128;
  static constexpr int WM = SPLIT_M ? BM / 2 : BM;              // a consumer
  static constexpr int WN = CW == 2 && !SPLIT_M ? BN / 2 : BN;  // warpgroup's
  static constexpr int MI = WM / 64;                            // 64-row wgmmas
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE_BYTES = (BM + BN) * BK * 2;
  static_assert(WM % 64 == 0 && (WN == 64 || WN == 128 || WN == 256), "wgmma tiling");
  static_assert(MI * WN / 2 <= MAX_ACC, "accumulators exceed budget");
  // the ring, the alignment slack before it and the two barriers a stage
  static constexpr int smem(int stages) {
    return ALIGN + stages * STAGE_BYTES + 2 * MAX_STAGES * 8;
  }
};

template <int WN, int TNSP>
__device__ __forceinline__ void wgmma(float (&d)[WN / 2], uint64_t da, uint64_t db) {
  if constexpr (WN == 64) wgmma_m64n64k16<TNSP>(d, da, db);
  else if constexpr (WN == 128) wgmma_m64n128k16<TNSP>(d, da, db);
  else wgmma_m64n256k16<TNSP>(d, da, db);
}

template <int BM, int BN, int CW>
__global__ void __launch_bounds__(Tile<BM, BN, CW>::THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b, const bf16* __restrict__ C,
            bf16* __restrict__ Out, int M, int N, int k_slice, int stages, int acc_bf16,
            int unroll_k, int order_nm, float alpha, float beta) {
  using T = Tile<BM, BN, CW>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~uintptr_t(ALIGN - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * T::STAGE_BYTES);
  uint64_t* empty = full + MAX_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      barrier_init(&full[s], 1);
      barrier_init(&empty[s], T::CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // block raster: "mn" walks n fastest, "nm" walks m fastest
  const int gm = M / BM, gn = N / BN;
  const int bi = order_nm ? blockIdx.x % gm : blockIdx.x / gn;
  const int bj = order_nm ? blockIdx.x / gm : blockIdx.x % gn;
  const int m0 = bi * BM, n0 = bj * BN;
  const int k_lo = blockIdx.y * k_slice;
  const int nkb = k_slice / BK;

  if (threadIdx.x >= T::CONSUMERS) {  // the producer warpgroup
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == T::CONSUMERS) {
      for (int kb = 0; kb < nkb; ++kb) {
        const int st = kb % stages;
        barrier_wait(&empty[st], ((kb / stages) & 1) ^ 1);
        uint8_t* a_s = ring + st * T::STAGE_BYTES;
        uint8_t* b_s = a_s + T::A_BYTES;
        const int k = k_lo + kb * BK;
        barrier_arrive_expect_tx(&full[st], T::STAGE_BYTES);
        tma_load_2d(a_s, &map_a, &full[st], k, m0);
        if constexpr (NK) {
          tma_load_2d(b_s, &map_b, &full[st], k, n0);
        } else {
#pragma unroll
          for (int j = 0; j < BN / KN_COLS; ++j)
            tma_load_2d(b_s + j * BK * 128, &map_b, &full[st], n0 + j * KN_COLS, k);
        }
      }
    }
  } else {  // a consumer warpgroup
    regs_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int wm0 = T::SPLIT_M ? wg * T::WM : 0;
    const int wn0 = CW == 2 && !T::SPLIT_M ? wg * T::WN : 0;
    float acc[T::MI][T::WN / 2];
#pragma unroll
    for (int i = 0; i < T::MI; ++i)
#pragma unroll
      for (int e = 0; e < T::WN / 2; ++e) acc[i][e] = 0.0f;

    constexpr int STEPS = BK / 16;  // k16 wgmmas per k block and row block
    for (int kb = 0; kb < nkb; ++kb) {
      const int st = kb % stages;
      barrier_wait(&full[st], (kb / stages) & 1);
      const uint8_t* a_s = ring + st * T::STAGE_BYTES;
      const uint8_t* b_s = a_s + T::A_BYTES;
#pragma unroll
      for (int i = 0; i < T::MI; ++i) fence_operands(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < STEPS; ++ks) {
        const uint64_t db =
            NK ? desc_k_major(b_s + wn0 * K_ROW + ks * 32, K_ROW)
               : desc_mn_major(b_s + (wn0 / KN_COLS) * BK * 128 + ks * 16 * 128, 128,
                               BK * 128);
#pragma unroll
        for (int i = 0; i < T::MI; ++i)
          wgmma<T::WN, NK ? 0 : 1>(
              acc[i], desc_k_major(a_s + (wm0 + 64 * i) * K_ROW + ks * 32, K_ROW), db);
        if (unroll_k == 2 && ks == STEPS / 2 - 1) wgmma_commit();
      }
      wgmma_commit();
#pragma unroll
      for (int i = 0; i < T::MI; ++i) fence_operands(acc[i]);
      if (acc_bf16) {  // the accumulator is stored in bf16 between k blocks
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < T::MI; ++i)
#pragma unroll
          for (int e = 0; e < T::WN / 2; ++e)
            acc[i][e] = __bfloat162float(__float2bfloat16(acc[i][e]));
        barrier_arrive(&empty[st]);
      } else {  // the previous k block's groups have retired: free its stage
        if (unroll_k == 2) wgmma_wait<2>();
        else wgmma_wait<1>();
        if (kb > 0) barrier_arrive(&empty[(kb - 1) % stages]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < T::MI; ++i) fence_operands(acc[i]);

    // epilogue from the fragment: alpha, beta * C, bf16 pairs
    bf16* out = Out + (size_t)blockIdx.y * M * N;
    const int warp = t / 32, lane = t % 32;
#pragma unroll
    for (int i = 0; i < T::MI; ++i) {
      const int row = m0 + wm0 + 64 * i + 16 * warp + lane / 4;
#pragma unroll
      for (int j = 0; j < T::WN / 8; ++j) {
        const int col = n0 + wn0 + 8 * j + 2 * (lane % 4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const size_t off = (size_t)(row + 8 * h) * N + col;
          float v0 = __fmul_rn(alpha, acc[i][4 * j + 2 * h]);
          float v1 = __fmul_rn(alpha, acc[i][4 * j + 2 * h + 1]);
          if (beta != 0.0f) {
            const uint32_t w = *reinterpret_cast<const uint32_t*>(C + off);
            v0 = __fadd_rn(v0, __fmul_rn(beta, bf16_lo(w)));
            v1 = __fadd_rn(v1, __fmul_rn(beta, bf16_hi(w)));
          }
          *reinterpret_cast<uint32_t*>(out + off) = pack_bf16x2(v0, v1);
        }
      }
    }
  }
}

template <int BM, int BN, int WARPS>
int launch_tile(const void* a, const void* b, const void* c, void* out, int m, int n,
                int k, int split_k, int stages, int acc_bf16, int unroll_k, int order_nm,
                float alpha, float beta, cudaStream_t stream) {
  using T = Tile<BM, BN, WARPS / 4>;
  constexpr auto kern = gemm_kernel<BM, BN, WARPS / 4>;
  cudaError_t e = opt_in_smem<kern>(T::smem(MAX_STAGES));
  if (e != cudaSuccess) return e;
  CUtensorMap map_a, map_b;
  e = tensor_map_2d(&map_a, a, m, k, BM, BK, K_ROW);
  if (e == cudaSuccess)
    e = NK ? tensor_map_2d(&map_b, b, n, k, BN, BK, K_ROW)
           : tensor_map_2d(&map_b, b, k, n, BK, KN_COLS, 128);
  if (e != cudaSuccess) return e;
  const dim3 grid((m / BM) * (n / BN), split_k);
  kern<<<grid, T::THREADS, T::smem(stages), stream>>>(
      map_a, map_b, static_cast<const bf16*>(c), static_cast<bf16*>(out), m, n,
      k / split_k, stages, acc_bf16, unroll_k, order_nm, alpha, beta);
  return cudaGetLastError();
}

template <int BM, int BN, int WARPS>
int tile_attributes(int stages, int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, gemm_kernel<BM, BN, WARPS / 4>);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = Tile<BM, BN, WARPS / 4>::smem(stages);
  return cudaSuccess;
}

}  // namespace

// (block_m, block_n, warps): every tile of 64-row wgmmas within the
// accumulator budget.  warps counts the consumer warps; two consumer
// warpgroups split BM >= 128 by rows, else BN >= 128 by columns.
#define GEMM_TILES(X)                                                            \
  X(64, 64, 4) X(64, 128, 4) X(64, 128, 8) X(64, 256, 4) X(64, 256, 8)           \
  X(128, 64, 4) X(128, 64, 8) X(128, 128, 4) X(128, 128, 8) X(128, 256, 8)       \
  X(256, 64, 4) X(256, 64, 8) X(256, 128, 8)

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// k is the full depth.  Shapes that the blocks do not divide, a stage count
// outside 2..4, an address TMA cannot read (16-byte alignment of a, b, and
// of their rows) or unaligned c and out are refused here, not launched.
int gemm_launch(const void* a, const void* b, const void* c, void* out, int m, int n,
                int k, int split_k, int block_m, int block_n, int warps, int stages,
                int acc_bf16, int unroll_k, int order_nm, float alpha, float beta,
                void* stream) {
  if (unroll_k < 1 || unroll_k > 2 || BK % (16 * unroll_k) != 0 || split_k < 1 ||
      stages < 2 || stages > MAX_STAGES || m % block_m != 0 || n % block_n != 0 ||
      k % split_k != 0 || k / split_k < BK || (k / split_k) % BK != 0)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(c) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GEMM_DISPATCH(BM_, BN_, W_)                                                  \
  if (block_m == BM_ && block_n == BN_ && warps == W_)                               \
    return launch_tile<BM_, BN_, W_>(a, b, c, out, m, n, k, split_k, stages, acc_bf16, \
                                     unroll_k, order_nm, alpha, beta, st);
  GEMM_TILES(GEMM_DISPATCH)
#undef GEMM_DISPATCH
  return cudaErrorInvalidValue;
}

// Registers, local (spill) bytes and dynamic shared memory of one tile
// with `stages` buffers.
int gemm_attributes(int block_m, int block_n, int warps, int stages, int* regs,
                    int* local_bytes, int* smem_bytes) {
#define GEMM_ATTRS(BM_, BN_, W_)                       \
  if (block_m == BM_ && block_n == BN_ && warps == W_) \
    return tile_attributes<BM_, BN_, W_>(stages, regs, local_bytes, smem_bytes);
  GEMM_TILES(GEMM_ATTRS)
#undef GEMM_ATTRS
  return cudaErrorInvalidValue;
}

const char* gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
