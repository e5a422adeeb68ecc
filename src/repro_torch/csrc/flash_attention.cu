// Flash attention for Hopper (sm_90a): online-softmax attention, GQA and
// causal, bf16 in and out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/attention/kernel.py::
// flash_attention (its body _flash_kernel).  Same function, same tunables
// where the meaning carries; the blocks are Hopper's, not the TPU's.
//
//   q (Hq, Tq, D), k and v (Hkv, Tk, D), out (Hq, Tq, D), all bf16 and
//   contiguous.  q head h reads kv head h / (Hq / Hkv): K and V are never
//   repeated in memory.  The causal mask aligns to the bottom right: row r
//   sees column c when r + (Tk - Tq) >= c; a masked logit is the finite
//   -1e30 of the reference, so a row with no visible column gives what the
//   reference gives (the mean of the V rows its tiles visited, or 0 when
//   none was), not NaN.
//
// Design.  One block takes block_q query rows of block_h q heads of one GQA
// group; each warp owns 16 rows of one head, holds their Q fragments and
// their output accumulator in registers, and walks the kv tiles.  The
// block_h heads share each K/V tile, which cp.async stages in shared memory
// two tiles deep, so the next tile loads while this one is used.  Per tile
// a warp computes S = Q K^T with mma.sync m16n8k16 (bf16 in, f32
// accumulate), scales it by d**-0.5 in f32, masks it, and takes the online
// softmax in f32: row max and row sum reduce over the four lanes of a quad
// with shuffles.  P goes to the P V products as a bf16 high part plus the
// bf16 of the remainder, two mma.sync each: the reference keeps P in f32;
// one bf16 rounding of P moved the output by 1.8e-3 to 3.4e-3 rel-L2 from
// it, as much as the bf16 accumulator's own rounding, whereas the split
// keeps ~16 bits (1.5e-4 at most; tests/test_torch_attention.py).  With
// acc_bf16 the accumulator is rounded to bf16 after every kv tile, as the
// reference stores it in acc_dtype.  With skip, the kv tiles that even the
// q tile's last row masks are not visited; they would change nothing for
// rows that see a column.  The output is acc / max(l, 1e-30).
//
// Head dim D is the build's (-DFA_D=64|128, two builds in parallel); block_kv
// and the warp count are template parameters (12 kernels a build); block_q
// (hence block_h = warps * 16 / block_q), causal, skip, acc_bf16, the
// shapes and the scale are runtime arguments.
//
// Bound at the default shape (32 q heads, 8 kv heads, Tq = Tk = 4096,
// D = 128, causal; H100 SXM data sheet): the 32 * 4096 * 4097 / 2 visible
// pairs need 4 * 128 FLOP each, 137.5 GFLOP, 0.139 ms at 989 TFLOP/s dense
// bf16; q, k, v and out (84 MB) take 0.025 ms at 3.35 TB/s; so the kernel is
// bound by the tensor cores.  It spends 1.5x those products (the P split)
// and, with skip = 0, the masked half of the tiles; mma.sync instead of
// wgmma, and no TMA, are what a later redesign changes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

#if !defined(FA_D)
#error "build with -DFA_D=64|128"
#endif

typedef __nv_bfloat16 bf16;

namespace {

constexpr int PAD = 8;  // bf16 of padding per shared-memory row (16 B)
constexpr int STAGES = 2;
constexpr float NEG_INF = -1e30f;

template <int D, int BKV, int WARPS>
struct Tile {
  static constexpr int THREADS = WARPS * 32;
  static constexpr int LD = D + PAD;           // a K or V row in shared memory
  static constexpr int TILE_ELEMS = BKV * LD;  // one K or V tile
  static constexpr int SMEM = STAGES * 2 * TILE_ELEMS * 2;
  static constexpr int NT = BKV / 8;     // S fragments (16 x 8) of a warp
  static constexpr int KD = D / 16;      // 16-deep steps of Q K^T
  static constexpr int ND = D / 8;       // output fragments (16 x 8) of a warp
  static constexpr int KV16 = BKV / 16;  // 16-deep steps of P V
  static_assert(BKV % 16 == 0 && D % 16 == 0, "whole fragments");
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// d (16x8, f32) += a (16x16, bf16, row-major) * b (16x8, bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Two probabilities as bf16 hi and lo pairs: hi + lo keeps ~16 bits of each.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16x2(x0, x1);
  lo = pack_bf16x2(x0 - bf16_lo(hi), x1 - bf16_hi(hi));
}

// Start the copies of kv rows [row0, row0 + BKV) of K and V into one stage.
template <int D, int BKV, int WARPS>
__device__ __forceinline__ void load_kv(bf16* ks, const bf16* k, const bf16* v, int row0) {
  using T = Tile<D, BKV, WARPS>;
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  bf16* vs = ks + T::TILE_ELEMS;
  for (int c = threadIdx.x; c < BKV * CHUNKS; c += T::THREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    const size_t src = (size_t)(row0 + r) * D + col;
    cp_async16(ks + r * T::LD + col, k + src);
    cp_async16(vs + r * T::LD + col, v + src);
  }
}

template <int D, int BKV, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 1)
fa_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K, const bf16* __restrict__ V,
          bf16* __restrict__ Out, int hq, int hkv, int tq, int tk, int bq, int causal, int skip,
          int acc_bf16, float scale) {
  using T = Tile<D, BKV, WARPS>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row and column pair
  const int slabs = bq / 16;             // warps per head
  const int bh = WARPS / slabs;          // heads per block
  const int qi = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y * bh + warp / slabs;
  const int kvh = blockIdx.y * bh / (hq / hkv);
  const int row0 = qi * bq + (warp % slabs) * 16;  // this warp's first q row
  const int off = tk - tq;

  uint32_t qf[T::KD][4];
  {
    const bf16* q = Q + ((size_t)h * tq + row0) * D;
#pragma unroll
    for (int kk = 0; kk < T::KD; ++kk) {
      const int c = kk * 16 + 2 * t;
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(q + g * D + c);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(q + (g + 8) * D + c);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(q + g * D + c + 8);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(q + (g + 8) * D + c + 8);
    }
  }
  float o[T::ND][4];
#pragma unroll
  for (int d = 0; d < T::ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // rows g and g + 8

  const int n_kv = tk / BKV;
  int n_iter = n_kv;
  if (causal && skip) {  // tiles past the one holding the q tile's last visible column
    const int last = qi * bq + bq - 1 + off;
    n_iter = last < 0 ? 0 : min(n_kv, last / BKV + 1);
  }
  const bf16* k = K + (size_t)kvh * tk * D;
  const bf16* v = V + (size_t)kvh * tk * D;
  if (n_iter > 0) load_kv<D, BKV, WARPS>(smem, k, v, 0);
  cp_async_commit();

  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: which 8x8 matrix, which row
  for (int j = 0; j < n_iter; ++j) {
    const bf16* ks = smem + (j & 1) * 2 * T::TILE_ELEMS;
    const bf16* vs = ks + T::TILE_ELEMS;
    if (j + 1 < n_iter)
      load_kv<D, BKV, WARPS>(smem + ((j + 1) & 1) * 2 * T::TILE_ELEMS, k, v, (j + 1) * BKV);
    cp_async_commit();  // an empty group past the end keeps the count
    cp_async_wait(1);   // this tile has landed
    __syncthreads();

    // S = Q K^T: K rows are the column-major B operand as stored
    float s[T::NT][4];
#pragma unroll
    for (int n = 0; n < T::NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < T::KD; ++kk) {
#pragma unroll
      for (int np = 0; np < T::NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + (np * 16 + (mi / 2) * 8 + mr) * T::LD + kk * 16 + (mi % 2) * 8);
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale and mask in f32; the running max starts from the previous one
    const bool need_mask = causal && row0 + off < j * BKV + BKV - 1;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < T::NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (need_mask && row0 + g + (e / 2) * 8 + off < j * BKV + n * 8 + 2 * t + (e % 2))
          x = NEG_INF;
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = __expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < T::NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[n][e] - m[e / 2]);
        s[n][e] = p;
        rs[e / 2] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + quad_sum(rs[i]);

    // O = O * alpha + P V: the S fragments are P's row-major A operand;
    // V rows, read transposed, are the column-major B operand
#pragma unroll
    for (int d = 0; d < T::ND; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }
#pragma unroll
    for (int kv = 0; kv < T::KV16; ++kv) {
      uint32_t hi[4], lo[4];
      split_pair(s[2 * kv][0], s[2 * kv][1], hi[0], lo[0]);
      split_pair(s[2 * kv][2], s[2 * kv][3], hi[1], lo[1]);
      split_pair(s[2 * kv + 1][0], s[2 * kv + 1][1], hi[2], lo[2]);
      split_pair(s[2 * kv + 1][2], s[2 * kv + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dp = 0; dp < T::ND / 2; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + (kv * 16 + (mi % 2) * 8 + mr) * T::LD + dp * 16 + (mi / 2) * 8);
        mma_bf16(o[2 * dp], hi, b[0], b[1]);
        mma_bf16(o[2 * dp], lo, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], hi, b[2], b[3]);
        mma_bf16(o[2 * dp + 1], lo, b[2], b[3]);
      }
    }
    if (acc_bf16) {  // the accumulator is stored in bf16 between kv tiles
#pragma unroll
      for (int d = 0; d < T::ND; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[d][e] = __bfloat162float(__float2bfloat16(o[d][e]));
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

  const float l0 = fmaxf(l[0], 1e-30f), l1 = fmaxf(l[1], 1e-30f);
  bf16* out = Out + ((size_t)h * tq + row0) * D;
#pragma unroll
  for (int d = 0; d < T::ND; ++d) {
    const int c = d * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(out + g * D + c) = pack_bf16x2(o[d][0] / l0, o[d][1] / l0);
    *reinterpret_cast<uint32_t*>(out + (g + 8) * D + c) =
        pack_bf16x2(o[d][2] / l1, o[d][3] / l1);
  }
}

template <int BKV, int WARPS>
int launch_tile(const void* q, const void* k, const void* v, void* out, int hq, int hkv,
                int tq, int tk, int bq, int bh, int causal, int skip, int acc_bf16, float scale,
                cudaStream_t stream) {
  using T = Tile<FA_D, BKV, WARPS>;
  auto kern = fa_kernel<FA_D, BKV, WARPS>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid(tq / bq, hq / bh);
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), hq, hkv, tq, tk, bq, causal, skip, acc_bf16, scale);
  return cudaGetLastError();
}

template <int BKV, int WARPS>
int tile_attributes(int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, fa_kernel<FA_D, BKV, WARPS>);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = Tile<FA_D, BKV, WARPS>::SMEM;
  return cudaSuccess;
}

}  // namespace

#define FA_TILES(X)                                                             \
  X(32, 1) X(32, 2) X(32, 4) X(32, 8) X(64, 1) X(64, 2) X(64, 4) X(64, 8)       \
  X(128, 1) X(128, 2) X(128, 4) X(128, 8)

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// d must be this build's head dim; every block must divide its dimension.
int fa_launch(const void* q, const void* k, const void* v, void* out, int hq, int hkv,
              int tq, int tk, int d, int block_q, int block_kv, int block_h, int causal,
              int skip, int acc_bf16, float scale, void* stream) {
  if (d != FA_D || hkv < 1 || hq % hkv != 0 || block_q < 16 || block_q % 16 != 0 ||
      block_h < 1 || (hq / hkv) % block_h != 0 || tq % block_q != 0 || tk % block_kv != 0)
    return cudaErrorInvalidValue;
  const int warps = block_h * block_q / 16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_DISPATCH(BKV_, W_)                                                           \
  if (block_kv == BKV_ && warps == W_)                                                  \
    return launch_tile<BKV_, W_>(q, k, v, out, hq, hkv, tq, tk, block_q, block_h, causal, \
                                 skip, acc_bf16, scale, st);
  FA_TILES(FA_DISPATCH)
#undef FA_DISPATCH
  return cudaErrorInvalidValue;
}

// Registers, local (spill) bytes and dynamic shared memory of one tile.
int fa_attributes(int block_kv, int warps, int* regs, int* local_bytes, int* smem_bytes) {
#define FA_ATTRS(BKV_, W_) \
  if (block_kv == BKV_ && warps == W_) return tile_attributes<BKV_, W_>(regs, local_bytes, smem_bytes);
  FA_TILES(FA_ATTRS)
#undef FA_ATTRS
  return cudaErrorInvalidValue;
}

const char* fa_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
