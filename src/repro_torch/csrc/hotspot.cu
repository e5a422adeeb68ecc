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
// Design: temporal blocking with the tile in registers.  One launch advances
// the domain `s` sweeps (tt, or what is left for the last launch).  A block
// owns a block_h x block_w output tile and computes it with its halo, s cells
// deep on every side, in whole warps: a lane owns a register block of ROWS
// rows x C consecutive columns, a warp 32 lanes side by side (32 C columns),
// the block WY warps stacked (ROWS WY rows), with C = ceil((block_w + 2s) /
// 32) and WY = ceil((block_h + 2s) / ROWS); the few columns and rows beyond
// the tile with its halo are halo too.  Every lane updates all its cells on
// every sweep.  The temperature stays in registers across the launch's
// sweeps; a sweep moves only the edges of a lane's block:
//   - left and right across lanes by __shfl_up_sync / __shfl_down_sync;
//   - up and down across warps through shared memory: each warp publishes
//     its top and bottom rows (2C stores a lane), one barrier, each lane
//     reads the row above and below its block (2C loads); two buffers
//     alternate, so that one barrier a sweep suffices.
// That is 2 / C shuffles and 4 / ROWS shared accesses a cell update (the
// shared-memory design before it made six loads and a store).  A cell at
// the tile's edge has no neighbour beyond it and takes itself in its place
// (shfl_up/down's own value at lane 0 and 31, the warp's own row at the top
// and bottom warp), as the reference's tiles do; that error travels one cell
// a sweep, so the output tile, s cells in, is exact.
//
// The domain's edge.  A neighbour outside the domain is the cell itself,
// the oracle's edge-replicated boundary.  A tile is shifted to lie inside
// the domain (its origin clamped to [0, H - ROWS WY] x [0, W - 32 C]), so a
// tile that reaches the domain's edge has its own edge there, and the
// tile-edge rule is the domain's rule: no block tests a cell for the
// domain's edge, and the output is exact over the whole domain, not only on
// the reference's central crop.  Only a domain smaller than one tile (the
// small test shapes) runs the EDGE path, a block-uniform branch that tests
// the cells of the last rows and columns.
//
// Power (power_smem, the reference's keep_power_vmem): 1 holds it on chip
// for the whole launch, in registers beside the temperature; 0 reads it
// from device memory (through L1) at every sweep.  The sweep loop runs in
// chunks of U sweeps unrolled (unroll_t; the last launch snaps it down to a
// divisor of its sweep count), so that the buffer parity is static inside a
// chunk.  The C launcher issues all ceil(n / tt) launches on the stream
// itself; the state lives in f32 between launches, alternating between
// `out` and a scratch buffer so that the last launch writes `out`.
//
// acc_dtype bf16 follows the reference exactly: temperature, power and the
// five constants rounded to bf16 at each launch and held as bf16, and every
// operation of the sweep a native bf16 add, subtract or multiply (one
// rounding each, none contracted into an FMA) in the order the expression
// parses, which is what PyTorch's and XLA's bf16 ops compute.  acc_dtype
// f32 lets nvcc fuse multiply-adds.
//
// Bound at the default shape (3248 x 3248 padded domain, 600 sweeps): each
// cell update is 9 f32 instructions, 600 x 3248^2 x 9 = 5.7e10, 1.70 ms at
// 3.35e13 instructions/s; reading temp and power and writing out once is
// 127 MB, 0.04 ms at 3.35 TB/s.  So it is bound by its operations.  The
// halo is the waste: a tile computes (32 C)(ROWS WY) cells for block_h x
// block_w outputs, and a launch re-reads the domain, so small tt pays
// device memory, large tt and small tiles pay halo work.
//
// Registers are the budget: a lane holds ROWS C temperatures (and as many
// powers), so a block of C columns may have at most HOT_MAX_THREADS(C)
// threads (its __launch_bounds__, which caps ptxas at 65536 / that many
// registers).  Shared memory is only the edge buffers, 2 x 2 x WY x 32 C
// floats, under 48 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// rows of a lane's register block
#define HOT_ROWS 8
// the most threads a block of C columns a lane may have: the register
// budget (kernel.py MAX_THREADS mirrors it)
#define HOT_MAX_THREADS(C) ((C) == 1 ? 768 : (C) == 2 ? 640 : (C) == 3 ? 512 : 352)

namespace {

constexpr int R = HOT_ROWS;
constexpr unsigned FULL = 0xffffffffu;

struct Consts {
  float step, rx, ry, rz, amb;
};

// One bf16 operation, rounded once to nearest even (sm_90's native bf16
// arithmetic; an explicit .rn is never contracted into an FMA).  For bf16
// operands it gives what the f32 operation rounded to bf16 gives, as
// PyTorch's and XLA's bf16 ops compute it: f32's 24 bits are at least
// 2 x 8 + 2, so the double rounding is innocuous for +, - and x.
__device__ __forceinline__ __nv_bfloat16 bop_add(__nv_bfloat16 a, __nv_bfloat16 b) {
  unsigned short r;
  asm("add.rn.bf16 %0, %1, %2;" : "=h"(r) : "h"(__bfloat16_as_ushort(a)), "h"(__bfloat16_as_ushort(b)));
  return __ushort_as_bfloat16(r);
}
__device__ __forceinline__ __nv_bfloat16 bop_sub(__nv_bfloat16 a, __nv_bfloat16 b) {
  unsigned short r;
  asm("sub.rn.bf16 %0, %1, %2;" : "=h"(r) : "h"(__bfloat16_as_ushort(a)), "h"(__bfloat16_as_ushort(b)));
  return __ushort_as_bfloat16(r);
}
__device__ __forceinline__ __nv_bfloat16 bop_mul(__nv_bfloat16 a, __nv_bfloat16 b) {
  unsigned short r;
  asm("mul.rn.bf16 %0, %1, %2;" : "=h"(r) : "h"(__bfloat16_as_ushort(a)), "h"(__bfloat16_as_ushort(b)));
  return __ushort_as_bfloat16(r);
}

// The accumulator's type: f32, or bf16 held as bf16 (acc_dtype bf16).
template <int ACC_BF16>
struct Acc {
  using V = float;
  struct K {
    float step, rx, ry, rz, amb;
  };
  __device__ static K consts(const Consts& c) { return {c.step, c.rx, c.ry, c.rz, c.amb}; }
  __device__ static V from(float x) { return x; }
  __device__ static float to(V x) { return x; }
  // In f32 nvcc may fuse.
  __device__ static V cell(V t, V p, V up, V down, V left, V right, const K& k) {
    return t + k.step * (p + k.ry * (up + down - 2.f * t) + k.rx * (left + right - 2.f * t) +
                         k.rz * (k.amb - t));
  }
};

template <>
struct Acc<1> {
  using V = __nv_bfloat16;
  struct K {
    V two, step, rx, ry, rz, amb;
  };
  __device__ static K consts(const Consts& c) {
    return {__float2bfloat16_rn(2.f), __float2bfloat16_rn(c.step), __float2bfloat16_rn(c.rx),
            __float2bfloat16_rn(c.ry), __float2bfloat16_rn(c.rz), __float2bfloat16_rn(c.amb)};
  }
  __device__ static V from(float x) { return __float2bfloat16_rn(x); }
  __device__ static float to(V x) { return __bfloat162float(x); }
  // Every operation rounded, left to right as the reference's expression
  // parses.
  __device__ static V cell(V t, V p, V up, V down, V left, V right, const K& k) {
    const V t2 = bop_mul(k.two, t);
    V a = bop_sub(bop_add(up, down), t2);
    a = bop_mul(k.ry, a);
    V s = bop_add(p, a);
    V b = bop_sub(bop_add(left, right), t2);
    b = bop_mul(k.rx, b);
    s = bop_add(s, b);
    const V c = bop_mul(k.rz, bop_sub(k.amb, t));
    s = bop_add(s, c);
    s = bop_mul(k.step, s);
    return bop_add(t, s);
  }
};

// Where a lane's cells lie: the global row of its block's first row, the
// global column of its first column, and (EDGE only) which of its rows and
// columns are the domain's last, whose missing neighbour is the cell itself.
struct Place {
  int gy, gx;
  uint32_t last_row, last_col;  // bit r / bit j
};

// The launch's sweeps on a lane's block: load, `sweeps` sweeps, store.
template <int C, int U, int ACC_BF16, int PSMEM, bool EDGE>
__device__ __forceinline__ void run(const float* __restrict__ tin, const float* __restrict__ pw,
                                    float* __restrict__ tout, int h, int w, int bh, int bw,
                                    int by, int bx, int sweeps, const Place& pl, void* smem,
                                    const Consts& consts) {
  using A = Acc<ACC_BF16>;
  using V = typename A::V;
  const typename A::K k = A::consts(consts);
  const int lane = threadIdx.x, wy = threadIdx.y, nwy = blockDim.y;
  // the offset of cell (r, j) of the lane's block in the domain, clamped
  // into it where the tile reaches past it (EDGE)
  auto at = [&](int r, int j) {
    const int y = EDGE ? min(pl.gy + r, h - 1) : pl.gy + r;
    const int x = EDGE ? min(pl.gx + j, w - 1) : pl.gx + j;
    return y * w + x;
  };

  V T[R][C];
  V P[PSMEM ? R : 1][C];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < C; ++j) {
      T[r][j] = A::from(__ldg(tin + at(r, j)));
      if (PSMEM) P[PSMEM ? r : 0][j] = A::from(__ldg(pw + at(r, j)));
    }

  // the edge buffers: [parity][top, bottom][warp][column j][lane]
  V* sm = static_cast<V*>(smem);
  const int plane = nwy * 32 * C;
  const int mine_top = wy * 32 * C + lane, mine_bot = plane + mine_top;
  // the row above this warp's block is the bottom row of the warp above,
  // or for the top warp its own top row (the tile's edge takes itself);
  // likewise below
  const int above = wy > 0 ? plane + (wy - 1) * 32 * C + lane : mine_top;
  const int below = wy + 1 < nwy ? (wy + 1) * 32 * C + lane : mine_bot;

#pragma unroll 1
  for (int c0 = 0; c0 < sweeps; c0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // U even keeps the parity static inside the chunk; U 1 alternates
      V* buf = sm + ((U % 2 == 0 ? u : c0 + u) & 1) * 2 * plane;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        buf[mine_top + j * 32] = T[0][j];
        buf[mine_bot + j * 32] = T[R - 1][j];
      }
      __syncthreads();
      V up_row[C], down_row[C];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        up_row[j] = buf[above + j * 32];
        down_row[j] = buf[below + j * 32];
      }
      V prev[C];  // the old values of the row above the current one
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // the neighbours across lanes; lane 0 and 31 are the tile's edge
        V left0 = __shfl_up_sync(FULL, T[r][C - 1], 1);
        V rightC = __shfl_down_sync(FULL, T[r][0], 1);
        if (lane == 0) left0 = T[r][0];
        if (lane == 31) rightC = T[r][C - 1];
        V nrow[C];
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const V t = T[r][j];
          const V up = r == 0 ? up_row[j] : prev[j];
          V down = r == R - 1 ? down_row[j] : T[r + 1][j];
          const V left = j == 0 ? left0 : T[r][j - 1];
          V right = j == C - 1 ? rightC : T[r][j + 1];
          if (EDGE) {
            if ((pl.last_row >> r) & 1) down = t;
            if ((pl.last_col >> j) & 1) right = t;
          }
          const V p = PSMEM ? P[PSMEM ? r : 0][j] : A::from(__ldg(pw + at(r, j)));
          nrow[j] = A::cell(t, p, up, down, left, right, k);
        }
#pragma unroll
        for (int j = 0; j < C; ++j) {
          prev[j] = T[r][j];
          T[r][j] = nrow[j];
        }
      }
    }
  }

  // the output tile's cells, inside the domain
  const int oy0 = by * bh, oy1 = min(oy0 + bh, h);
  const int ox0 = bx * bw, ox1 = min(ox0 + bw, w);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int gy = pl.gy + r;
    if (gy < oy0 || gy >= oy1) continue;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int gx = pl.gx + j;
      if (gx >= ox0 && gx < ox1) tout[static_cast<size_t>(gy) * w + gx] = A::to(T[r][j]);
    }
  }
}

template <int C, int U, int ACC_BF16, int PSMEM>
__global__ void __launch_bounds__(HOT_MAX_THREADS(C), 1)
hotspot_kernel(const float* __restrict__ tin, const float* __restrict__ pw,
               float* __restrict__ tout, int h, int w, int bh, int bw, int sweeps, int gh,
               int gw, int col_major, Consts k) {
  extern __shared__ float sm[];
  const int b = blockIdx.x;
  const int by = col_major ? b % gh : b / gw;
  const int bx = col_major ? b / gh : b % gw;
  const int th = R * blockDim.y, tw = 32 * C;  // the tile with its halo
  // the tile's origin, s cells before the output tile, shifted to lie
  // inside the domain where the domain holds it
  const int ty = max(min(by * bh - sweeps, h - th), 0);
  const int tx = max(min(bx * bw - sweeps, w - tw), 0);
  Place pl;
  pl.gy = ty + threadIdx.y * R;
  pl.gx = tx + threadIdx.x * C;
  pl.last_row = pl.last_col = 0;
  if (th > h || tw > w) {
    // a domain smaller than the tile: the tile starts at its edge and
    // reaches past its end, whose last row and column take themselves
#pragma unroll
    for (int r = 0; r < R; ++r) pl.last_row |= static_cast<uint32_t>(pl.gy + r >= h - 1) << r;
#pragma unroll
    for (int j = 0; j < C; ++j) pl.last_col |= static_cast<uint32_t>(pl.gx + j >= w - 1) << j;
    run<C, U, ACC_BF16, PSMEM, true>(tin, pw, tout, h, w, bh, bw, by, bx, sweeps, pl, sm, k);
  } else {
    run<C, U, ACC_BF16, PSMEM, false>(tin, pw, tout, h, w, bh, bw, by, bx, sweeps, pl, sm, k);
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int C, int U, int ACC_BF16, int PSMEM>
int launch_one(const float* tin, const float* pw, float* tout, int h, int w, int bh, int bw,
               int sweeps, int col_major, const Consts& k, cudaStream_t stream) {
  const int wy = cdiv(bh + 2 * sweeps, R);
  if (32 * wy > HOT_MAX_THREADS(C)) return cudaErrorInvalidValue;
  const int smem = 2 * 2 * wy * 32 * C * static_cast<int>(sizeof(float));  // under 48 KB
  const int gh = cdiv(h, bh), gw = cdiv(w, bw);
  hotspot_kernel<C, U, ACC_BF16, PSMEM><<<gh * gw, dim3(32, wy), smem, stream>>>(
      tin, pw, tout, h, w, bh, bw, sweeps, gh, gw, col_major, k);
  return cudaGetLastError();
}

template <int C, int U, int ACC_BF16, int PSMEM>
int attributes_of(int* regs, int* local_bytes, int* max_threads) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, hotspot_kernel<C, U, ACC_BF16, PSMEM>);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *max_threads = attr.maxThreadsPerBlock;
  return cudaSuccess;
}

}  // namespace

// The compiled tiles: columns a lane C x unroll_t x acc_dtype x power_smem
// (kernel.py tiles() mirrors them).  With block_w a power of two up to 128
// and tt up to 10, block_w + 2 tt spans 1, 2, 3 or 5 warp widths (32 C),
// never 4; at 5 columns, two sweeps unrolled spill, so only unroll_t 1.
#define HOT_COLS 5
#define HOT_PS(X, C_, U_, A_) X(C_, U_, A_, 0) X(C_, U_, A_, 1)
#define HOT_ACC(X, C_, U_) HOT_PS(X, C_, U_, 0) HOT_PS(X, C_, U_, 1)
#define HOT_UNROLL(X, C_) HOT_ACC(X, C_, 1) HOT_ACC(X, C_, 2)
#define HOT_TILES(X) HOT_UNROLL(X, 1) HOT_UNROLL(X, 2) HOT_UNROLL(X, 3) HOT_ACC(X, 5, 1)

extern "C" {

// Advance `temp` n_sweeps sweeps into `out`, ceil(n_sweeps / tt) launches on
// `stream`; scratch is a second (h, w) f32 buffer (temp is not written).
// Returns the cudaError_t of the first launch that failed (0 on success).
// block_h, block_w >= 1 with C = ceil((block_w + 2 tt) / 32) a compiled
// tile's and 32 ceil((block_h + 2 tt) / HOT_ROWS) <= HOT_MAX_THREADS(C);
// unroll_t 1 or 2 (1 at 5 columns), snapped down per launch to a divisor
// of its sweep count.
int hotspot_launch(const void* temp, const void* power, void* out, void* scratch, int h, int w,
                   int n_sweeps, int tt, int block_h, int block_w, int unroll_t, int acc_bf16,
                   int power_smem, int col_major, float step, float rx, float ry, float rz,
                   float amb, void* stream) {
  if (h < 1 || w < 1 || n_sweeps < 0 || tt < 1 || block_h < 1 || block_w < 1 || unroll_t < 1 ||
      unroll_t > 2 || cdiv(block_w + 2 * tt, 32) > HOT_COLS)
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
    const int u = sweeps % unroll_t ? 1 : unroll_t;
    const int c = cdiv(block_w + 2 * sweeps, 32);
    float* dst = bufs[(launches - 1 - l) % 2];
    int err = cudaErrorInvalidValue;
#define HOT_DISPATCH(C_, U_, A_, P_)                                        \
  if (c == C_ && u == U_ && acc_bf16 == A_ && power_smem == P_)            \
    err = launch_one<C_, U_, A_, P_>(src, pw, dst, h, w, block_h, block_w, sweeps, col_major, \
                                     k, st);
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
int hotspot_attributes(int cols, int unroll_t, int acc_bf16, int power_smem, int* regs,
                       int* local_bytes, int* max_threads) {
#define HOT_ATTRS(C_, U_, A_, P_)                                              \
  if (cols == C_ && unroll_t == U_ && acc_bf16 == A_ && power_smem == P_)     \
    return attributes_of<C_, U_, A_, P_>(regs, local_bytes, max_threads);
  HOT_TILES(HOT_ATTRS)
#undef HOT_ATTRS
  return cudaErrorInvalidValue;
}

const char* hotspot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
