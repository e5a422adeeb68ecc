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
// Design.  A block owns a block_h x block_w output tile and runs block_w x
// (block_h / RC) threads: a thread computes RC rows (row_chunk) of one
// column, so a warp's reads of a row are consecutive.  The block first
// stages its (block_h + F - 1) x (block_w + F - 1) input tile, halo and
// all, in shared memory (zero past the image's edge, which only outputs
// past the edge read), which replaces the reference's gather of
// overlapping tiles outside the kernel.  The filter is read from shared
// memory (FSMEM, filter_smem = 1) or from __constant__ memory, copied there
// on the launch's stream (the paper's read-only choice); with a bf16
// accumulator the filter is rounded to bf16 first, into shared memory or,
// by a one-block kernel, into the scratch that the constant copy reads, so
// the taps read it as it is (rounded at every tap from constant memory,
// the 8-row, fully unrolled 15 x 15 tile spilled).  The taps run i
// outer and j inner, in chunks of UFH rows and UFW columns unrolled and the
// chunks rolled (unroll_fh, unroll_fw, snapped to divisors of F as the
// reference's snap_unroll snaps them).  F is the build's (-DCONV_F, one
// build per filter size); RC, UFH, UFW, the accumulator and the filter's
// home are template parameters, the tile a runtime one.
//
// acc_dtype bf16 follows the reference's per-tap rounding exactly: image
// and filter values rounded to bf16, the product rounded to bf16 and the
// sum rounded to bf16 after every tap, each from one f32 operation
// (__fmul_rn, __fadd_rn: nvcc contracts neither into an FMA), as PyTorch's
// bf16 ops compute them.  acc_dtype f32 accumulates with FMAs.
//
// Bound at the default shape (4096 x 4096 image, 15 x 15 filter; H100 SXM
// data sheet): 4082^2 outputs x 225 taps x 2 FLOP = 7.5 GFLOP take 0.112 ms
// at 67 TFLOP/s f32; the image and output (134 MB) take 0.040 ms at 3.35
// TB/s.  So it is bound by its operations; each tap here also reads shared
// memory once, whose rate is a quarter of the FMA rate, and bf16 adds two
// roundings a tap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(CONV_F) || !defined(CONV_UFH)
#error "build with -DCONV_F=<filter size> -DCONV_UFH=<its row unroll>"
#endif

namespace {

constexpr int F = CONV_F;
constexpr int UFH = CONV_UFH;
constexpr int MAX_THREADS = 512;
static_assert(F % UFH == 0, "the row unroll divides the filter");

__constant__ float c_filt[F * F];

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The filter rounded to bf16, for the constant copy with acc_dtype bf16.
__global__ void round_filter(const float* __restrict__ filt, float* __restrict__ out) {
  for (int k = threadIdx.x; k < F * F; k += blockDim.x) out[k] = bf16_round(filt[k]);
}

template <int RC, int UFW, int ACC_BF16, int FSMEM>
__global__ void __launch_bounds__(MAX_THREADS, 1)
conv_kernel(const float* __restrict__ img, const float* __restrict__ filt,
            float* __restrict__ out, int h, int w, int bh, int bw) {
  extern __shared__ float smem[];
  const int th = bh + F - 1, tw = bw + F - 1;
  float* halo = smem;            // th x tw
  float* sfilt = smem + th * tw;  // F x F, with FSMEM
  const int oh = h - F + 1, ow = w - F + 1;
  const int oy0 = blockIdx.y * bh, ox0 = blockIdx.x * bw;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  for (int k = tid; k < th * tw; k += nthreads) {
    const int y = oy0 + k / tw, x = ox0 + k % tw;
    const float v = (y < h && x < w) ? img[static_cast<size_t>(y) * w + x] : 0.f;
    halo[k] = ACC_BF16 ? bf16_round(v) : v;
  }
  if (FSMEM) {
    for (int k = tid; k < F * F; k += nthreads) sfilt[k] = ACC_BF16 ? bf16_round(filt[k]) : filt[k];
  }
  __syncthreads();

  const int tx = threadIdx.x, r0 = threadIdx.y * RC;
  float acc[RC];
#pragma unroll
  for (int r = 0; r < RC; ++r) acc[r] = 0.f;

#pragma unroll 1
  for (int io = 0; io < F / UFH; ++io) {
#pragma unroll
    for (int iu = 0; iu < UFH; ++iu) {
      const int i = io * UFH + iu;
#pragma unroll 1
      for (int jo = 0; jo < F / UFW; ++jo) {
#pragma unroll
        for (int ju = 0; ju < UFW; ++ju) {
          const int j = jo * UFW + ju;
          const float f = FSMEM ? sfilt[i * F + j] : c_filt[i * F + j];
          const float* src = halo + (r0 + i) * tw + tx + j;
#pragma unroll
          for (int r = 0; r < RC; ++r) {
            const float v = src[r * tw];
            if (ACC_BF16)
              acc[r] = bf16_round(__fadd_rn(acc[r], bf16_round(__fmul_rn(v, f))));
            else
              acc[r] = fmaf(v, f, acc[r]);
          }
        }
      }
    }
  }

  const int x = ox0 + tx;
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    const int y = oy0 + r0 + r;
    if (y < oh && x < ow) out[static_cast<size_t>(y) * ow + x] = acc[r];
  }
}

template <int RC, int UFW, int ACC_BF16, int FSMEM>
int launch_tile(const float* img, const float* filt, float* scratch, float* out, int h, int w,
                int bh, int bw, cudaStream_t stream) {
  if constexpr (F % UFW != 0) {
    return cudaErrorInvalidValue;
  } else {
    auto kern = conv_kernel<RC, UFW, ACC_BF16, FSMEM>;
    const int smem = ((bh + F - 1) * (bw + F - 1) + (FSMEM ? F * F : 0)) * sizeof(float);
    static int smem_set = 48 * 1024;
    if (smem > smem_set) {
      const cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      smem_set = smem;
    }
    if (!FSMEM) {
      const float* src = filt;
      if (ACC_BF16) {
        round_filter<<<1, 256, 0, stream>>>(filt, scratch);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return e;
        src = scratch;
      }
      const cudaError_t e = cudaMemcpyToSymbolAsync(c_filt, src, F * F * sizeof(float), 0,
                                                    cudaMemcpyDeviceToDevice, stream);
      if (e != cudaSuccess) return e;
    }
    const int oh = h - F + 1, ow = w - F + 1;
    const dim3 grid((ow + bw - 1) / bw, (oh + bh - 1) / bh);
    kern<<<grid, dim3(bw, bh / RC), smem, stream>>>(img, filt, out, h, w, bh, bw);
    return cudaGetLastError();
  }
}

template <int RC, int UFW, int ACC_BF16, int FSMEM>
int tile_attributes(int* regs, int* local_bytes, int* max_threads) {
  if constexpr (F % UFW != 0) {
    return cudaErrorInvalidValue;
  } else {
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, conv_kernel<RC, UFW, ACC_BF16, FSMEM>);
    if (e != cudaSuccess) return e;
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    *max_threads = attr.maxThreadsPerBlock;
    return cudaSuccess;
  }
}

}  // namespace

#define CONV_MEM(X, R_, U_, A_) X(R_, U_, A_, 0) X(R_, U_, A_, 1)
#define CONV_ACC(X, R_, U_) CONV_MEM(X, R_, U_, 0) CONV_MEM(X, R_, U_, 1)
#define CONV_UFW(X, R_) CONV_ACC(X, R_, 1) CONV_ACC(X, R_, 3) CONV_ACC(X, R_, 5) CONV_ACC(X, R_, 15)
#define CONV_TILES(X) CONV_UFW(X, 1) CONV_UFW(X, 2) CONV_UFW(X, 4) CONV_UFW(X, 8)

extern "C" {

// Launch on `stream`; returns the cudaError_t of the filter's copy or of the
// launches (0 on success).  fh and fw must be this build's F and unroll_fh
// its UFH; unroll_fw divides F, row_chunk divides block_h, and the block has
// 32 to 512 threads.  scratch holds F * F floats (read only with acc_bf16
// and the filter in constant memory).  Launches on one stream at a time:
// the constant filter's copy and the kernel are ordered on `stream` only.
int conv_launch(const void* img, const void* filt, void* scratch, void* out, int h, int w,
                int fh, int fw, int block_h, int block_w, int row_chunk, int unroll_fh,
                int unroll_fw, int acc_bf16, int filter_smem, void* stream) {
  const int threads = block_w * (row_chunk > 0 ? block_h / row_chunk : 0);
  if (fh != F || fw != F || unroll_fh != UFH || h < F || w < F || block_h < 1 || block_w < 1 ||
      row_chunk < 1 || block_h % row_chunk != 0 || threads < 32 || threads > MAX_THREADS)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* im = static_cast<const float*>(img);
  const float* fi = static_cast<const float*>(filt);
  float* sc = static_cast<float*>(scratch);
  float* o = static_cast<float*>(out);
#define CONV_DISPATCH(R_, U_, A_, M_)                                                  \
  if (row_chunk == R_ && unroll_fw == U_ && acc_bf16 == A_ && filter_smem == M_) \
    return launch_tile<R_, U_, A_, M_>(im, fi, sc, o, h, w, block_h, block_w, st);
  CONV_TILES(CONV_DISPATCH)
#undef CONV_DISPATCH
  return cudaErrorInvalidValue;
}

// Registers, local (spill) bytes and the most threads a block may have, of
// one compiled tile.
int conv_attributes(int row_chunk, int unroll_fw, int acc_bf16, int filter_smem, int* regs,
                    int* local_bytes, int* max_threads) {
#define CONV_ATTRS(R_, U_, A_, M_)                                                     \
  if (row_chunk == R_ && unroll_fw == U_ && acc_bf16 == A_ && filter_smem == M_) \
    return tile_attributes<R_, U_, A_, M_>(regs, local_bytes, max_threads);
  CONV_TILES(CONV_ATTRS)
#undef CONV_ATTRS
  return cudaErrorInvalidValue;
}

const char* conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
