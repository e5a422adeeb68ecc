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
// Bound at the default shape (32 q heads, 8 kv heads, Tq = Tk = 4096,
// D = 128, causal; H100 SXM data sheet): the 32 * 4096 * 4097 / 2 visible
// pairs need 4 * 128 FLOP each, 137.5 GFLOP, 0.139 ms at 989 TFLOP/s dense
// bf16; q, k, v and out (84 MB) take 0.025 ms at 3.35 TB/s; so the kernel is
// bound by the tensor cores, which on Hopper run at full rate only through
// wgmma.  P goes to the P V products as a bf16 high part plus the bf16 of
// the remainder (the reference keeps P in f32; one bf16 rounding moved the
// output as much as the bf16 accumulator's own rounding), so the kernel
// issues 1.5x the bound's products: its floor is 0.2085 ms.
//
// Design (the building blocks are in hopper.cuh).  One block takes
// ROWS = block_h * block_q query rows, 64 or 128: the block_h heads of one
// GQA group over one q range, stacked into 64-row wgmma tiles, so that they
// share every K and V tile.  Warp-specialised: a producer warpgroup gives
// up its registers (setmaxnreg.dec) and one of its threads loads Q once and
// then keeps the K and V tiles in flight by TMA into a ring of three
// shared-memory buffers, each guarded by a "full" and an "empty" mbarrier
// for its K and for its V, so that a K slot refills once S is in (a ring
// of two was as fast at the benchmark shape, PERF.md).  One
// consumer warpgroup per 64 rows takes the registers (setmaxnreg.inc)
// and, per kv tile j:
//   1. issues S = Q K^T by wgmma from shared memory (Q and K both K-major,
//      N = block_kv) into f32 registers, and with it O += P V of tile j - 1
//      (below), and waits for S alone;
//   2. scales, masks and takes the online softmax in f32 in the accumulator
//      layout while that P V runs: a thread holds rows 16 * warp + lane / 4
//      and + 8, so a row's max and sum reduce over a quad with two
//      shuffles; the logits are kept in log2 units, so each exponential is
//      a subtraction and an ex2;
//   3. waits for the P V of tile j - 1, arrives on its V's "empty"
//      barrier (its K's once S was in) and rescales O, its f32
//      accumulator in registers, unless no row of the warp moved its max;
//   4. converts P into bf16 hi and lo pairs (one cvt.rn.bf16x2 each),
//      which are, chunk by 16-column chunk, the register A operands of
//      wgmma with no shuffle: P V is two register-A wgmmas a chunk against
//      V from shared memory (V is MN-major: transposed-B).
// Two consumer warpgroups take turns to issue their wgmmas (two named
// barriers), so that one's softmax runs while the other's products do.
// With acc_bf16 the accumulator is rounded to bf16 after every kv tile, as
// the reference stores it in acc_dtype.  With skip, the kv tiles that even
// the q tile's last row masks are not visited (the same count for every
// stacked head).  The epilogue writes acc / max(l, 1e-30) as bf16 pairs
// from registers.  The longest causal rows go first: the grid walks the
// head groups fastest and the q tiles from the last.
//
// Shared memory: Q, and each K or V tile, as [64-column half][rows][128 B]
// with TMA's 128 B swizzle: a 16-deep k step of a K-major operand moves the
// descriptor 32 B inside the swizzled row, and the second half of a d = 128
// row starts a whole half-tile on; every box is a multiple of 8 rows, so
// every 1024 B swizzle atom stays aligned.
//
// Head dim D is the build's (-DFA_D=64|128, two builds in parallel);
// (block_kv, consumer warpgroups) are template parameters, the 6 of
// FA_TILES a build; block_q (hence block_h = ROWS / block_q), causal,
// skip, acc_bf16, the shapes and the scale are runtime arguments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

#if !defined(FA_D)
#error "build with -DFA_D=64|128"
#endif

typedef __nv_bfloat16 bf16;
using namespace hopper;

namespace {

constexpr int D = FA_D;
constexpr int HALF = 128;           // bytes of a row's 64-column half: its swizzle
constexpr int HALVES = D / 64;
constexpr int STAGES = 3;           // depth of the K and V ring
constexpr int ALIGN = 1024;         // a 128 B swizzle repeats every 1024 B
constexpr int MAX_FRAG = 192;       // S, P (hi + lo) and O registers of a consumer thread
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr float NEG_INF = -1e30f;

template <int BKV, int CW>
struct Tile {
  static constexpr int ROWS = CW * 64;
  static constexpr int CONSUMERS = CW * 128;
  static constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
  static constexpr int Q_BYTES = ROWS * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;     // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int NS = BKV / 2;               // S accumulators of a thread
  static constexpr int NO = D / 2;                 // O accumulators of a thread
  static constexpr int KV16 = BKV / 16;            // 16-deep chunks of P V
  static_assert(D % 64 == 0 && (BKV == 32 || BKV == 64 || BKV == 128), "wgmma tiling");
  static_assert(NS + KV16 * 8 + NO <= MAX_FRAG, "fragments exceed budget");
  // alignment slack, Q, the ring and the barriers (Q's, and a full and an
  // empty barrier each for K and for V of every stage)
  static constexpr int SMEM = ALIGN + Q_BYTES + STAGES * STAGE_BYTES + (1 + 4 * STAGES) * 8;
};

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 32) wgmma_m64n32k16<0>(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_m64n64k16<0>(d, da, db, scale_d);
  else wgmma_m64n128k16<0>(d, da, db, scale_d);
}

// O (64 x N) += P V for one 16-deep chunk: P from registers, V MN-major
// (transposed B); N is the head dim
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_m64n64k16_rs<1>(d, a, db);
  else wgmma_m64n128k16_rs<1>(d, a, db);
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x by the special-function unit (ex2.approx, as __expf uses it)
__device__ __forceinline__ float exp2f_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Two floats rounded to bf16 (to nearest even) in one instruction, x0 in the
// low half: what pack_bf16x2 gives, for a third of its instructions.
__device__ __forceinline__ uint32_t cvt_bf16x2(float x0, float x1) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(x1), "f"(x0));
  return r;
}

// Two probabilities as bf16 hi and lo pairs: hi + lo keeps ~16 bits of each.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = cvt_bf16x2(x0, x1);
  lo = cvt_bf16x2(x0 - bf16_lo(hi), x1 - bf16_hi(hi));
}

// What a consumer thread's two rows, r and r + 8 of its 16-row slab, take
// to be masked and scaled.  Row r at position p in its head sees column c
// when p + Tk - Tq >= c; the thread's columns are col0 + 8 n (+ 1), so it
// keeps lim = p + Tk - Tq - col0 and masks 8 n (+ 1) > lim - c_lo.
struct Rows {
  int lim[2];
  float scale_log2;  // the softmax scale times log2(e)
};

// Pin O and P's pairs across the asynchronous P V wgmmas.
template <int BKV>
__device__ __forceinline__ void fence_pv(float (&o)[D / 2], uint32_t (&hi)[BKV / 16][4],
                                         uint32_t (&lo)[BKV / 16][4]) {
  fence_operands(o);
#pragma unroll
  for (int c = 0; c < BKV / 16; ++c) {
    fence_operands(hi[c]);
    fence_operands(lo[c]);
  }
}

// Scale and mask S in f32 and take the online softmax over the tile of
// columns c_lo ..: the running max starts from the previous one; S becomes
// P = exp(S - m) in place; l takes the rescaled sum; alpha is each row's
// rescale of the accumulator.  The logits and m are kept in log2 units
// (the scale times log2(e)), so that each exponential is one subtraction
// and one ex2; the mask value stays -1e30, so a row that sees no column
// still gets exp(0) = 1 for each logit, as in the reference.
template <int BKV, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[BKV / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const Rows& rw, int c_lo) {
  float mx[2] = {m[0], m[1]};
  const int last[2] = {rw.lim[0] - c_lo, rw.lim[1] - c_lo};
#pragma unroll
  for (int n = 0; n < BKV / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * n + e] * rw.scale_log2;
      if (MASK && 8 * n + (e % 2) > last[e / 2]) x = NEG_INF;
      s[4 * n + e] = x;
      mx[e / 2] = fmaxf(mx[e / 2], x);
    }
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = quad_max(mx[i]);
    alpha[i] = exp2f_approx(m[i] - mx[i]);
    m[i] = mx[i];
  }
#pragma unroll
  for (int n = 0; n < BKV / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f_approx(s[4 * n + e] - m[e / 2]);
      s[4 * n + e] = p;
      rs[e / 2] += p;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + quad_sum(rs[i]);
}

// The same, with the mask's comparisons only on the tiles that need them.
template <int BKV>
__device__ __forceinline__ void online_softmax(float (&s)[BKV / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], const Rows& rw, bool mask,
                                               int c_lo) {
  if (mask) softmax_tile<BKV, true>(s, m, l, alpha, rw, c_lo);
  else softmax_tile<BKV, false>(s, m, l, alpha, rw, c_lo);
}

// P as the register A operands of P V, chunk by 16 columns: the f32
// accumulator layout of S pairs up as wgmma's A fragment with no shuffle.
template <int BKV>
__device__ __forceinline__ void to_pairs(const float (&s)[BKV / 2], uint32_t (&hi)[BKV / 16][4],
                                         uint32_t (&lo)[BKV / 16][4]) {
#pragma unroll
  for (int c = 0; c < BKV / 16; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_pair(s[8 * c + 2 * i], s[8 * c + 2 * i + 1], hi[c][i], lo[c][i]);
}

// O *= alpha, row by row; skipped when no row of the warp moved its max
// (alpha exactly 1 everywhere), which changes nothing.
__device__ __forceinline__ void scale_rows(float (&o)[D / 2], const float (&alpha)[2]) {
  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    o[4 * n] *= alpha[0];
    o[4 * n + 1] *= alpha[0];
    o[4 * n + 2] *= alpha[1];
    o[4 * n + 3] *= alpha[1];
  }
}

__device__ __forceinline__ void round_bf16(float (&o)[D / 2]) {
#pragma unroll
  for (int e = 0; e < D / 2; e += 2) {
    const uint32_t w = cvt_bf16x2(o[e], o[e + 1]);
    o[e] = bf16_lo(w);
    o[e + 1] = bf16_hi(w);
  }
}

// S = Q K^T for one kv tile, issued and committed: Q and K K-major, 16
// columns of the head dim a wgmma (the first overwrites S); the second 64
// columns a half-tile on.
template <int BKV>
__device__ __forceinline__ void issue_s(float (&s)[BKV / 2], const uint8_t* q_w,
                                        const uint8_t* k_s, int rows) {
  fence_operands(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int at = (ks % 4) * 32;  // 16 columns on, inside the swizzled half row
    wgmma_ss<BKV>(s, desc_k_major(q_w + (ks / 4) * rows * HALF + at, HALF),
                  desc_k_major(k_s + (ks / 4) * BKV * HALF + at, HALF), ks > 0);
  }
  wgmma_commit();
}

// O += P V for one kv tile, issued and committed: P's bf16 hi and lo pairs
// from registers, two wgmmas a 16-row chunk of V (MN-major, transposed B).
template <int BKV>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], uint32_t (&hi)[BKV / 16][4],
                                         uint32_t (&lo)[BKV / 16][4], const uint8_t* v_s) {
  fence_pv<BKV>(o, hi, lo);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < BKV / 16; ++c) {
    // rows 16 c .. 16 c + 15 of V; its second 64 columns a half-tile on
    const uint64_t dv = desc_mn_major(v_s + c * 16 * HALF, HALF, BKV * HALF);
    wgmma_pv<D>(o, hi[c], dv);
    wgmma_pv<D>(o, lo[c], dv);
  }
  wgmma_commit();
}

template <int BKV, int CW>
__global__ void __launch_bounds__(Tile<BKV, CW>::THREADS, 1)
fa_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
          const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ Out, int hq, int hkv,
          int tq, int tk, int bq, int causal, int skip, int acc_bf16, float scale) {
  using T = Tile<BKV, CW>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~uintptr_t(ALIGN - 1));
  uint8_t* ring = q_s + T::Q_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + STAGES * T::STAGE_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;
  if (threadIdx.x == 0) {
    barrier_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      barrier_init(&k_full[s], 1);
      barrier_init(&v_full[s], 1);
      barrier_init(&k_empty[s], T::CONSUMERS);
      barrier_init(&v_empty[s], T::CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int bh = T::ROWS / bq;                 // heads stacked in the block
  const int qi = gridDim.y - 1 - blockIdx.y;   // the longest causal rows first
  const int h0 = blockIdx.x * bh;
  const int off = tk - tq;
  const int n_kv = tk / BKV;
  int n_iter = n_kv;
  if (causal && skip) {  // tiles past the one holding the q tile's last visible column
    const int last = qi * bq + bq - 1 + off;
    n_iter = last < 0 ? 0 : min(n_kv, last / BKV + 1);
  }

  if (threadIdx.x >= T::CONSUMERS) {  // the producer warpgroup
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == T::CONSUMERS && n_iter > 0) {
      barrier_arrive_expect_tx(q_full, T::Q_BYTES);
      for (int hh = 0; hh < bh; ++hh)
#pragma unroll
        for (int c = 0; c < HALVES; ++c)
          tma_load_2d(q_s + c * T::ROWS * HALF + hh * bq * HALF, &map_q, q_full, c * 64,
                      (h0 + hh) * tq + qi * bq);
      const int kv0 = h0 / (hq / hkv) * tk;
      for (int j = 0; j < n_iter; ++j) {
        const int st = j % STAGES;
        const uint32_t free = ((j / STAGES) & 1) ^ 1;
        uint8_t* k_s = ring + st * T::STAGE_BYTES;
        uint8_t* v_s = k_s + T::KV_BYTES;
        barrier_wait(&k_empty[st], free);
        barrier_arrive_expect_tx(&k_full[st], T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < HALVES; ++c)
          tma_load_2d(k_s + c * BKV * HALF, &map_k, &k_full[st], c * 64, kv0 + j * BKV);
        barrier_wait(&v_empty[st], free);
        barrier_arrive_expect_tx(&v_full[st], T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < HALVES; ++c)
          tma_load_2d(v_s + c * BKV * HALF, &map_v, &v_full[st], c * 64, kv0 + j * BKV);
      }
    }
  } else {  // a consumer warpgroup: block rows 64 wg .. 64 wg + 63
    regs_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r0 = 64 * wg + 16 * (t / 32) + lane / 4;  // this thread's rows r0, r0 + 8
    const int col0 = 2 * (lane % 4);
    // a row's position in its head (a stacked head restarts at qi * bq),
    // plus Tk - Tq, less the thread's first column: the mask's limit
    const Rows rows{{qi * bq + r0 % bq + off - col0, qi * bq + (r0 + 8) % bq + off - col0},
                    scale * LOG2E};
    const uint8_t* q_w = q_s + 64 * wg * HALF;
    float o[T::NO];
#pragma unroll
    for (int e = 0; e < T::NO; ++e) o[e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // m in log2 units
    float s[T::NS], alpha[2];
    uint32_t hi[T::KV16][4], lo[T::KV16][4];
    // whether kv tile j holds a column the q tile's first row (the same for
    // every stacked head) does not see
    const auto masks = [&](int j) { return qi * bq + off < j * BKV + BKV - 1; };
    // Two consumer warpgroups take turns to issue (named barriers 1 and 2),
    // so that one's products run while the other takes its softmax.  Each
    // issues n_iter + 1 times; warpgroup 1 lets 0 go first.
    constexpr bool PINGPONG = CW == 2;
    const auto my_turn = [&] {
      if constexpr (PINGPONG) named_barrier_sync(1 + wg, T::CONSUMERS);
    };
    const auto your_turn = [&](int issue) {
      if constexpr (PINGPONG) {
        if (wg == 0 || issue < n_iter) named_barrier_arrive(2 - wg, T::CONSUMERS);
      }
    };

    // Pipelined: tile j's S = Q K^T and tile j - 1's P V go out together,
    // and tile j's softmax runs while that P V is on the tensor cores.
    if (n_iter > 0) {
      if (PINGPONG && wg == 1) named_barrier_arrive(1, T::CONSUMERS);
      barrier_wait(q_full, 0);
      barrier_wait(&k_full[0], 0);
      my_turn();
      issue_s<BKV>(s, q_w, ring, T::ROWS);
      your_turn(0);
      wgmma_wait<0>();
      fence_operands(s);
      barrier_arrive(&k_empty[0]);
      online_softmax<BKV>(s, m, l, alpha, rows, causal && masks(0), 0);
      to_pairs<BKV>(s, hi, lo);
    }
    for (int j = 1; j < n_iter; ++j) {
      const int st = j % STAGES, pv = (j - 1) % STAGES;
      barrier_wait(&k_full[st], (j / STAGES) & 1);
      barrier_wait(&v_full[pv], ((j - 1) / STAGES) & 1);
      my_turn();
      issue_s<BKV>(s, q_w, ring + st * T::STAGE_BYTES, T::ROWS);
      issue_pv<BKV>(o, hi, lo, ring + pv * T::STAGE_BYTES + T::KV_BYTES);
      your_turn(j);
      wgmma_wait<1>();  // S is in; P V may still run
      fence_operands(s);
      barrier_arrive(&k_empty[st]);  // tile j's K is no longer read
      online_softmax<BKV>(s, m, l, alpha, rows, causal && masks(j), j * BKV);
      wgmma_wait<0>();
      fence_pv<BKV>(o, hi, lo);
      barrier_arrive(&v_empty[pv]);  // nor tile j - 1's V
      if (acc_bf16) round_bf16(o);  // the accumulator is stored in bf16 between kv tiles
      scale_rows(o, alpha);
      to_pairs<BKV>(s, hi, lo);
    }
    if (n_iter > 0) {
      const int pv = (n_iter - 1) % STAGES;
      barrier_wait(&v_full[pv], ((n_iter - 1) / STAGES) & 1);
      my_turn();
      issue_pv<BKV>(o, hi, lo, ring + pv * T::STAGE_BYTES + T::KV_BYTES);
      your_turn(n_iter);
      wgmma_wait<0>();
      fence_pv<BKV>(o, hi, lo);
      barrier_arrive(&v_empty[pv]);
      if (acc_bf16) round_bf16(o);
    }

    // epilogue from the fragment: acc / max(l, 1e-30), bf16 pairs
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      const float li = fmaxf(l[i], 1e-30f);
      bf16* out = Out + ((size_t)(h0 + r / bq) * tq + qi * bq + r % bq) * D + col0;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(out + 8 * n) =
            pack_bf16x2(o[4 * n + 2 * i] / li, o[4 * n + 2 * i + 1] / li);
    }
  }
}

template <int BKV, int CW>
int launch_tile(const void* q, const void* k, const void* v, void* out, int hq, int hkv,
                int tq, int tk, int bq, int causal, int skip, int acc_bf16, float scale,
                cudaStream_t stream) {
  using T = Tile<BKV, CW>;
  constexpr auto kern = fa_kernel<BKV, CW>;
  cudaError_t e = opt_in_smem<kern>(T::SMEM);
  if (e != cudaSuccess) return e;
  // 2-D maps over (Hq * Tq, D) and (Hkv * Tk, D), read in 64-column boxes
  CUtensorMap map_q, map_k, map_v;
  e = tensor_map_2d(&map_q, q, (uint64_t)hq * tq, D, bq, 64, HALF);
  if (e == cudaSuccess) e = tensor_map_2d(&map_k, k, (uint64_t)hkv * tk, D, BKV, 64, HALF);
  if (e == cudaSuccess) e = tensor_map_2d(&map_v, v, (uint64_t)hkv * tk, D, BKV, 64, HALF);
  if (e != cudaSuccess) return e;
  const dim3 grid(hq / (T::ROWS / bq), tq / bq);
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(map_q, map_k, map_v, static_cast<bf16*>(out),
                                              hq, hkv, tq, tk, bq, causal, skip, acc_bf16,
                                              scale);
  return cudaGetLastError();
}

template <int BKV, int CW>
int tile_attributes(int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, fa_kernel<BKV, CW>);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = Tile<BKV, CW>::SMEM;
  return cudaSuccess;
}

}  // namespace

// (block_kv, consumer warpgroups): a block of 64 or 128 rows, one consumer
// warpgroup per 64.
#define FA_TILES(X) X(32, 1) X(32, 2) X(64, 1) X(64, 2) X(128, 1) X(128, 2)

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// d must be this build's head dim; every block must divide its dimension,
// block_h * block_q be 64 or 128 rows and block_q a multiple of 8; an
// address TMA cannot read (16-byte alignment of q, k, v) or an unaligned
// out is refused here, not launched.
int fa_launch(const void* q, const void* k, const void* v, void* out, int hq, int hkv,
              int tq, int tk, int d, int block_q, int block_kv, int block_h,
              int causal, int skip, int acc_bf16, float scale, void* stream) {
  const int rows = block_h * block_q;
  if (d != FA_D || hkv < 1 || hq % hkv != 0 || block_q < 8 || block_q % 8 != 0 ||
      block_h < 1 || (hq / hkv) % block_h != 0 || tq % block_q != 0 || tk % block_kv != 0 ||
      (rows != 64 && rows != 128))
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) return cudaErrorMisalignedAddress;
  const int cw = rows / 64;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_DISPATCH(BKV_, CW_)                                                           \
  if (block_kv == BKV_ && cw == CW_)                                                     \
    return launch_tile<BKV_, CW_>(q, k, v, out, hq, hkv, tq, tk, block_q, causal, skip, \
                                  acc_bf16, scale, st);
  FA_TILES(FA_DISPATCH)
#undef FA_DISPATCH
  return cudaErrorInvalidValue;
}

// Registers, local (spill) bytes and dynamic shared memory of one tile.
int fa_attributes(int block_kv, int warpgroups, int* regs, int* local_bytes,
                  int* smem_bytes) {
#define FA_ATTRS(BKV_, CW_)                                       \
  if (block_kv == BKV_ && warpgroups == CW_)                      \
    return tile_attributes<BKV_, CW_>(regs, local_bytes, smem_bytes);
  FA_TILES(FA_ATTRS)
#undef FA_ATTRS
  return cudaErrorInvalidValue;
}

const char* fa_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
