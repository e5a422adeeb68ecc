// Single-channel 2-D convolution for Hopper (sm_90a): the "valid"
// correlation of an image with an F x F filter, f32 in and out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/conv2d/kernel.py::conv2d
// (its body _conv_kernel, and the halo gather outside it, _make_tiles).
// Same function, same tunables; the blocks are Hopper's.
//
//   out(y, x) = sum_{i < F, j < F} image(y + i, x + j) * filt(i, j)
//
//   image (H, W) f32, filt (F, F) f32, out (H - F + 1, W - F + 1) f32.
//
// Bound at the default shape (4096 x 4096 image, 15 x 15 filter; H100 SXM
// data sheet): 4082^2 outputs x 225 taps are 3.75e9 FMAs, 0.112 ms at
// 3.35e13 f32 instructions/s; the image and output (134 MB) take 0.040 ms
// at 3.35 TB/s.  So it is bound by its FMAs, and every other instruction a
// thread issues (a shared load, a filter load, address and loop
// arithmetic) takes an issue slot from them one for one.
//
// Design: register blocking.  A block owns a block_h x block_w output tile
// and runs (block_w / RX) x (block_h / RY) threads; a thread owns RY rows
// (row_chunk) x RX consecutive columns (col_chunk) of it, in registers.
// The block first stages its (block_h + F - 1) x (block_w + F - 1) input
// tile, halo and all, in shared memory, its rows padded to a multiple of 4
// floats: by 16-byte cp.async with a row loop and a column loop (zero past
// the image's edge, which only outputs past the edge read; a byte count
// per copy, no division per element), or, where the image's rows are not
// 16-byte aligned, by plain loads.  Staging is not double-buffered: a
// block's tile is at most 86 KB and its threads few, so two or more blocks
// are resident on an SM and one block's staging overlaps another's taps.
//
// The taps.  A thread walks the input rows its outputs read, in chunks of
// UFH filter rows (unroll_fh): a chunk reads RY + UFH - 1 rows, and each
// row is read once, into a register window of RX + UFW - 1 values, by
// 16- or 8-byte loads where the window's start is aligned (col_chunk 4 or
// 2), and feeds every output row of the thread that the chunk's filter rows
// pair with it: RY x RX outputs x UFH x UFW taps from RY + UFH - 1 windows.
// The columns run in chunks of UFW taps (unroll_fw), a rolled chunk loading
// its own window.  No register array is indexed at runtime.  Each output
// still takes its taps in the order i outer, j inner: chunks, and rows in
// a chunk, run in i order, and a row's taps in j order.
//
// The filter.  In __constant__ memory, copied there on the launch's stream
// (the paper's read-only choice): where the chunk loops are unrolled its
// indices are compile-time, and each output row's taps take its values as
// constant-bank operands of the FFMAs (ptxas folds the loads); a rolled
// chunk loads them by index, per lane (see lane0), once per output row and
// chunk.  With filter_smem it is staged beside the tile (rows padded to FP
// words) and read by 16-byte broadcast loads, a filter row's chunk at a
// time.  Never a load per lane and tap.
//
// The earlier design's 13.6 ms cliff (unroll_fh 1, unroll_fw 15, constant
// filter, blocks of 32 to 128 threads) came from the filter: its rolled row
// loop read each value by a ULDC indexed by a uniform register, and those
// ran 8 to 14 times slower once eight or more blocks shared an SM (capping
// the resident blocks at four removed it); the same loads made per lane do
// not (PERF.md section 6).
//
// acc_dtype bf16 follows the reference's per-tap rounding exactly: image
// and filter rounded to bf16 once, at staging (a one-block kernel packs the
// filter as bf16 pairs (f, f) for constant memory), and each tap one native
// bf16 multiply and one bf16 add, each rounding once from the exact result
// (sm_90's mul.rn / add.rn .bf16, never contracted into an FMA), which is
// what PyTorch's bf16 ops give: an f32 result rounded to bf16, as f32's 24
// bits are at least 2 x 8 + 2.  With col_chunk 2 and 4 two neighbouring
// outputs share one bf16x2 instruction.  acc_dtype f32 accumulates by FMA.
//
// F (-DCONV_F), UFH (-DCONV_UFH) and the accumulator (-DCONV_ACC_BF16) are
// the build's, one build each (and the filter's home, -DCONV_FSMEM, where
// UFH is F); RY, RX, UFW and the filter's home are template parameters
// (CONV_TILES), the block's shape a runtime one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

// The most threads a block of an RY x RX tile may have: its launch bound,
// which caps ptxas at 65536 / that many registers a thread, 128 at 512 and
// 168 at 384 (kernel.py max_threads mirrors it).  The bf16 8 x 4 tile with
// the filter in shared memory spilled 632 bytes at 128 registers and needs
// 153, so the bf16 tiles of 32 outputs are built for 384 threads; at 384
// the f32 one ran 23 % slower (fewer blocks an SM), so it keeps 512.
#define CONV_MAX_THREADS(RY, RX) (CONV_ACC_BF16 && (RY) * (RX) >= 32 ? 384 : 512)

#if !defined(CONV_F) || !defined(CONV_UFH) || !defined(CONV_ACC_BF16)
#error "build with -DCONV_F=<filter size> -DCONV_UFH=<its row unroll> -DCONV_ACC_BF16=<0|1>"
#endif

namespace {

constexpr int F = CONV_F;
constexpr int UFH = CONV_UFH;
constexpr int ACC_BF16 = CONV_ACC_BF16;
constexpr int FP = (F + 3) / 4 * 4;  // a filter row's pitch in shared memory, in words
static_assert(F % UFH == 0, "the row unroll divides the filter");

// f32 bits, or (acc bf16) the bf16 pair (f, f)
__constant__ uint32_t c_filt[F * F];

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t bf16_pair(float f) {
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(f));
  return b | (b << 16);
}

// The filter as the taps read it: f32 bits, or bf16 pairs.
__device__ __forceinline__ uint32_t filter_word(float f) {
  return ACC_BF16 ? bf16_pair(f) : __float_as_uint(f);
}

// The filter packed as bf16 pairs, for the constant copy with acc_dtype bf16.
__global__ void pack_filter(const float* __restrict__ filt, uint32_t* __restrict__ out) {
  for (int k = threadIdx.x; k < F * F; k += blockDim.x) out[k] = bf16_pair(filt[k]);
}

// bf16 arithmetic, each operation rounded once to nearest even: two lanes
// packed in a 32-bit word, or one in 16 bits.
__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t badd2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned short bmul(unsigned short a, unsigned short b) {
  unsigned short d;
  asm("mul.rn.bf16 %0, %1, %2;" : "=h"(d) : "h"(a), "h"(b));
  return d;
}
__device__ __forceinline__ unsigned short badd(unsigned short a, unsigned short b) {
  unsigned short d;
  asm("add.rn.bf16 %0, %1, %2;" : "=h"(d) : "h"(a), "h"(b));
  return d;
}

// The bf16 values (held as f32 with zero low bits) of two floats, packed.
__device__ __forceinline__ uint32_t pair_of(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Filter words from shared memory.  The loads are volatile so that each
// stays where it is used: merged across the unrolled rows they would hold
// up to RY x F words live at once.
__device__ __forceinline__ uint4 lds128(const uint32_t* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
  return v;
}
__device__ __forceinline__ uint32_t lds32(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];"
               : "=r"(v)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
  return v;
}

// N consecutive floats of shared memory from p into a register window, by
// 16- and 8-byte loads as far as p's alignment allows (V floats: 4 is 16
// bytes, 2 is 8), the rest one at a time.
template <int N, int V>
__device__ __forceinline__ void load_window(float (&win)[N], const float* p) {
  constexpr int N4 = V == 4 ? N / 4 : 0;
  constexpr int N2 = V >= 2 ? (N - 4 * N4) / 2 : 0;
#pragma unroll
  for (int c = 0; c < N4; ++c) {
    const float4 v = *reinterpret_cast<const float4*>(p + 4 * c);
    win[4 * c] = v.x;
    win[4 * c + 1] = v.y;
    win[4 * c + 2] = v.z;
    win[4 * c + 3] = v.w;
  }
#pragma unroll
  for (int c = 0; c < N2; ++c) {
    const float2 v = *reinterpret_cast<const float2*>(p + 4 * N4 + 2 * c);
    win[4 * N4 + 2 * c] = v.x;
    win[4 * N4 + 2 * c + 1] = v.y;
  }
#pragma unroll
  for (int q = 4 * N4 + 2 * N2; q < N; ++q) win[q] = p[q];
}

// A thread's accumulators: RY x RX f32, or bf16 as pairs of neighbouring
// outputs (RX even) or one at a time (RX 1).
template <int RY, int RX>
struct Acc {
  static constexpr int NA = ACC_BF16 ? (RX == 1 ? 1 : RX / 2) : RX;
  uint32_t a[RY][NA];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < RY; ++r)
#pragma unroll
      for (int x = 0; x < NA; ++x) a[r][x] = 0u;
  }

  // The UFW taps of one filter row's column chunk on output row r, from
  // the window of the input row they read: win[x + ju] * f[ju].
  template <int N, int UFW>
  __device__ __forceinline__ void taps(int r, const float (&win)[N], const uint32_t (&f)[UFW]) {
    if constexpr (!ACC_BF16) {
#pragma unroll
      for (int ju = 0; ju < UFW; ++ju) {
        const float fv = __uint_as_float(f[ju]);
#pragma unroll
        for (int x = 0; x < RX; ++x)
          a[r][x] = __float_as_uint(fmaf(win[x + ju], fv, __uint_as_float(a[r][x])));
      }
    } else if constexpr (RX == 1) {
#pragma unroll
      for (int ju = 0; ju < UFW; ++ju) {
        const unsigned short w = static_cast<unsigned short>(__float_as_uint(win[ju]) >> 16);
        const unsigned short fv = static_cast<unsigned short>(f[ju]);
        a[r][0] = badd(static_cast<unsigned short>(a[r][0]), bmul(w, fv));
      }
    } else {
      // outputs (2p, 2p + 1) at tap ju read the window pair (2p + ju,
      // 2p + ju + 1): even ju an aligned pair, odd ju one shifted by one
#pragma unroll
      for (int ju = 0; ju < UFW; ++ju) {
#pragma unroll
        for (int p = 0; p < RX / 2; ++p) {
          const int q = 2 * p + ju;
          a[r][p] = badd2(a[r][p], bmul2(pair_of(win[q], win[q + 1]), f[ju]));
        }
      }
    }
  }

  __device__ __forceinline__ float get(int r, int x) const {
    if constexpr (!ACC_BF16) return __uint_as_float(a[r][x]);
    else if constexpr (RX == 1) return __uint_as_float(a[r][0] << 16);
    else if (x % 2) return __uint_as_float(a[r][x / 2] & 0xffff0000u);
    else return __uint_as_float(a[r][x / 2] << 16);
  }
};

template <int RY, int RX, int UFW, int FSMEM>
__global__ void __launch_bounds__(CONV_MAX_THREADS(RY, RX), 1)
conv_kernel(const float* __restrict__ img, const float* __restrict__ filt,
            float* __restrict__ out, int h, int w, int bh, int bw, int pitch, int aligned) {
  extern __shared__ __align__(16) float smem[];
  const int th = bh + F - 1, tw = bw + F - 1;
  float* tile = smem;                                                 // th x pitch
  uint32_t* sfilt = reinterpret_cast<uint32_t*>(smem + th * pitch);  // F x FP, with FSMEM
  const int oh = h - F + 1, ow = w - F + 1;
  const int oy0 = blockIdx.y * bh, ox0 = blockIdx.x * bw;
  const int tx = threadIdx.x, ty = threadIdx.y, nx = blockDim.x, ny = blockDim.y;

  // Stage the tile with its halo: rows by threadIdx.y, columns by
  // threadIdx.x, zero past the image's edge.
  if (aligned) {
    const int tw4 = (tw + 3) / 4;  // 16-byte chunks a row (pitch is 4 tw4)
    for (int r = ty; r < th; r += ny) {
      const int y = oy0 + r;
      for (int c = tx; c < tw4; c += nx) {
        const int x = ox0 + 4 * c;
        const int n = y < h && x < w ? min(4, w - x) : 0;
        const float* src = n ? img + static_cast<size_t>(y) * w + x : img;
        cp_async16_zfill(tile + r * pitch + 4 * c, src, 4 * n);
      }
    }
    cp_async_commit();
    cp_async_wait(0);
    if (ACC_BF16) {  // round what this thread copied, once
      for (int r = ty; r < th; r += ny)
        for (int c = tx; c < tw4; c += nx) {
          float4* q = reinterpret_cast<float4*>(tile + r * pitch + 4 * c);
          float4 v = *q;
          v.x = bf16_round(v.x), v.y = bf16_round(v.y), v.z = bf16_round(v.z),
          v.w = bf16_round(v.w);
          *q = v;
        }
    }
  } else {
    for (int r = ty; r < th; r += ny) {
      const int y = oy0 + r;
      for (int c = tx; c < tw; c += nx) {
        const int x = ox0 + c;
        const float v = y < h && x < w ? img[static_cast<size_t>(y) * w + x] : 0.f;
        tile[r * pitch + c] = ACC_BF16 ? bf16_round(v) : v;
      }
    }
  }
  if (FSMEM) {
    for (int i = ty; i < F; i += ny)
      for (int j = tx; j < FP; j += nx)
        sfilt[i * FP + j] = j < F ? filter_word(filt[i * F + j]) : 0u;
  }
  __syncthreads();

  // 0, in a register that the compiler takes to differ by lane: a rolled
  // chunk's filter values then load from constant memory per lane (LDC),
  // not by a uniform register (ULDC), which ran 3 to 11 times slower in
  // small blocks, many resident on an SM (PERF.md, the 13.6 ms cliff)
  const int lane0 = UFH < F || UFW < F ? (blockDim.z - 1) * tx : 0;
  const float* base = tile + ty * RY * pitch + tx * RX;
  Acc<RY, RX> acc;
  acc.zero();
  constexpr int N = RX + UFW - 1;  // a window: one column chunk of one input row
  constexpr int V = UFW < F ? 1 : RX % 4 == 0 ? 4 : RX % 2 == 0 ? 2 : 1;
#pragma unroll 1
  for (int io = 0; io < F / UFH; ++io) {
    const int i0 = io * UFH;
#pragma unroll
    for (int k = 0; k < RY + UFH - 1; ++k) {  // the chunk's input rows
      const float* row = base + (i0 + k) * pitch;
#pragma unroll 1
      for (int jo = 0; jo < F / UFW; ++jo) {
        const int j0 = jo * UFW;
        float win[N];
        load_window<N, V>(win, row + j0);
#pragma unroll
        for (int r = 0; r < RY; ++r) {
          const int iu = k - r;  // the filter row that pairs input row k with output row r
          if (iu < 0 || iu >= UFH) continue;
          uint32_t f[UFW];
          if constexpr (FSMEM) {
            const uint32_t* fr = sfilt + (i0 + iu) * FP + j0;
            if constexpr (UFW == F) {
#pragma unroll
              for (int c = 0; c < FP / 4; ++c) {
                const uint4 v = lds128(fr + 4 * c);
                const uint32_t vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  if (4 * c + e < UFW) f[4 * c + e] = vv[e];
              }
            } else {
#pragma unroll
              for (int ju = 0; ju < UFW; ++ju) f[ju] = lds32(fr + ju);
            }
          } else {
            // an offset the compiler cannot see through (it is 0), so that
            // each output row's taps load their filter values afresh rather
            // than hold RY filter rows live across the input rows
            int fresh;
            asm volatile("mov.b32 %0, 0;" : "=r"(fresh));
#pragma unroll
            for (int ju = 0; ju < UFW; ++ju)
              f[ju] = c_filt[(i0 + iu) * F + j0 + ju + fresh + lane0];
          }
          acc.template taps<N, UFW>(r, win, f);
        }
      }
    }
  }

  const int y0 = oy0 + ty * RY, x0 = ox0 + tx * RX;
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    if (y0 + r >= oh) break;
    float* o = out + static_cast<size_t>(y0 + r) * ow + x0;
#pragma unroll
    for (int x = 0; x < RX; ++x)
      if (x0 + x < ow) o[x] = acc.get(r, x);
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int RY, int RX, int UFW, int FSMEM>
int launch_tile(const float* img, const float* filt, uint32_t* scratch, float* out, int h, int w,
                int bh, int bw, cudaStream_t stream) {
  if constexpr (F % UFW != 0) {
    return cudaErrorInvalidValue;
  } else {
    constexpr auto kern = conv_kernel<RY, RX, UFW, FSMEM>;
    if ((bh / RY) * (bw / RX) > CONV_MAX_THREADS(RY, RX)) return cudaErrorInvalidValue;
    const int pitch = (bw + F - 1 + 3) / 4 * 4;
    const int smem = ((bh + F - 1) * pitch + (FSMEM ? F * FP : 0)) * 4;
    cudaError_t e = opt_in_smem<kern>(smem);
    if (e != cudaSuccess) return e;
    if (!FSMEM) {
      const void* src = filt;
      if (ACC_BF16) {
        pack_filter<<<1, 256, 0, stream>>>(filt, scratch);
        e = cudaGetLastError();
        if (e != cudaSuccess) return e;
        src = scratch;
      }
      e = cudaMemcpyToSymbolAsync(c_filt, src, F * F * sizeof(uint32_t), 0,
                                  cudaMemcpyDeviceToDevice, stream);
      if (e != cudaSuccess) return e;
    }
    const int aligned =
        w % 4 == 0 && bw % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0;
    const dim3 grid(cdiv(w - F + 1, bw), cdiv(h - F + 1, bh));
    kern<<<grid, dim3(bw / RX, bh / RY), smem, stream>>>(img, filt, out, h, w, bh, bw, pitch,
                                                         aligned);
    return cudaGetLastError();
  }
}

template <int RY, int RX, int UFW, int FSMEM>
int tile_attributes(int* regs, int* local_bytes, int* max_threads) {
  if constexpr (F % UFW != 0) {
    return cudaErrorInvalidValue;
  } else {
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, conv_kernel<RY, RX, UFW, FSMEM>);
    if (e != cudaSuccess) return e;
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    *max_threads = attr.maxThreadsPerBlock;
    return cudaSuccess;
  }
}

}  // namespace

// The compiled tiles: (row_chunk, col_chunk), the outputs a thread owns
// (kernel.py TILES mirrors them), at most 32.  Each is built at every
// unroll_fw dividing F and both homes of the filter.
#define CONV_TILES(X) \
  X(1, 1) X(2, 1) X(4, 1) X(8, 1) X(1, 2) X(2, 2) X(4, 2) X(8, 2) X(1, 4) X(2, 4) X(4, 4) X(8, 4)

// A build may hold one home of the filter (-DCONV_FSMEM): the fully
// unrolled rows, the longest to compile, build each home apart.
#ifdef CONV_FSMEM
#define CONV_MEM(X, RY_, RX_, U_) X(RY_, RX_, U_, CONV_FSMEM)
#else
#define CONV_MEM(X, RY_, RX_, U_) X(RY_, RX_, U_, 0) X(RY_, RX_, U_, 1)
#endif
#define CONV_UFW(X, RY_, RX_)                           \
  CONV_MEM(X, RY_, RX_, 1) CONV_MEM(X, RY_, RX_, 3) \
  CONV_MEM(X, RY_, RX_, 5) CONV_MEM(X, RY_, RX_, 15)

extern "C" {

// Launch on `stream`; returns the cudaError_t of the filter's copy or of the
// launches (0 on success).  fh and fw must be this build's F, unroll_fh its
// UFH and acc_bf16 its accumulator; unroll_fw divides F, row_chunk divides
// block_h, col_chunk block_w, and the block has at most
// CONV_MAX_THREADS(row_chunk, col_chunk) threads.  scratch
// holds F * F words (written only with acc_bf16 and the filter in constant
// memory).  Launches on one stream at a time: the constant filter's copy
// and the kernel are ordered on `stream` only.
int conv_launch(const void* img, const void* filt, void* scratch, void* out, int h, int w,
                int fh, int fw, int block_h, int block_w, int row_chunk, int col_chunk,
                int unroll_fh, int unroll_fw, int acc_bf16, int filter_smem, void* stream) {
  if (fh != F || fw != F || unroll_fh != UFH || acc_bf16 != ACC_BF16 || h < F || w < F ||
      row_chunk < 1 || col_chunk < 1 || block_h < row_chunk || block_w < col_chunk ||
      block_h % row_chunk != 0 || block_w % col_chunk != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* im = static_cast<const float*>(img);
  const float* fi = static_cast<const float*>(filt);
  uint32_t* sc = static_cast<uint32_t*>(scratch);
  float* o = static_cast<float*>(out);
#define CONV_DISPATCH(RY_, RX_, U_, M_)                                                   \
  if (row_chunk == RY_ && col_chunk == RX_ && unroll_fw == U_ && filter_smem == M_) \
    return launch_tile<RY_, RX_, U_, M_>(im, fi, sc, o, h, w, block_h, block_w, st);
#define CONV_TILE_DISPATCH(RY_, RX_) CONV_UFW(CONV_DISPATCH, RY_, RX_)
  CONV_TILES(CONV_TILE_DISPATCH)
#undef CONV_TILE_DISPATCH
#undef CONV_DISPATCH
  return cudaErrorInvalidValue;
}

// Registers, local (spill) bytes and the most threads a block may have, of
// one compiled tile.
int conv_attributes(int row_chunk, int col_chunk, int unroll_fw, int filter_smem, int* regs,
                    int* local_bytes, int* max_threads) {
#define CONV_ATTRS(RY_, RX_, U_, M_)                                                      \
  if (row_chunk == RY_ && col_chunk == RX_ && unroll_fw == U_ && filter_smem == M_) \
    return tile_attributes<RY_, RX_, U_, M_>(regs, local_bytes, max_threads);
#define CONV_TILE_ATTRS(RY_, RX_) CONV_UFW(CONV_ATTRS, RY_, RX_)
  CONV_TILES(CONV_TILE_ATTRS)
#undef CONV_TILE_ATTRS
#undef CONV_ATTRS
  return cudaErrorInvalidValue;
}

const char* conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
