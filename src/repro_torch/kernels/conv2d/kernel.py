"""The Hopper 2-D convolution: its ctypes launcher and its plain PyTorch
version.

The kernel is ``csrc/conv2d.cu`` (CUDA C++ for sm_90a, register-blocked: a
block stages its output tile's input, halo and all, in shared memory by
16-byte ``cp.async``, and each thread computes ``row_chunk`` x
``col_chunk`` outputs in registers, reading each input row it needs once
into a register window that feeds all its outputs; the filter in
``__constant__`` or shared memory); it replaces the Pallas TPU kernel
``repro/kernels/conv2d/kernel.py::conv2d`` and the halo gather outside it.
It is built with ``nvcc`` at the first launch (:mod:`repro_torch._build`),
one library per (filter size, ``unroll_fh``, ``acc_dtype``) and, with the
filter's rows unrolled whole, per ``filter_smem`` (:func:`variant`), and
bound with :mod:`ctypes`.

:func:`conv2d_plain` computes the same function with PyTorch ops, step for
step as the kernel does: one tap at a time, i outer and j inner; with
``acc_dtype="bf16"`` the image and filter rounded to bf16 and the product
and the running sum rounded to bf16 at every tap, as the reference
accumulates in bf16.  It is what CPU tensors run, and what the kernel is
held against on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import _build

#: the menus the libraries launch (``csrc/conv2d.cu``); ``space.py`` admits
#: exactly what they launch.  block_h starts at 8: a tile stages F - 1 halo
#: rows, 14 at F 15, which at 1 to 4 output rows is 4.5 to 15 times the
#: rows it computes.  block_w starts at 32: a row of a block has at least
#: ROW_THREADS threads.
BLOCK_H = (8, 16, 32, 64)
BLOCK_W = (32, 64, 128, 256)
ROW_CHUNK = (1, 2, 4, 8)
#: output columns a thread computes (the BAT convolution's tile_size_x):
#: 1 reads no input value twice in a row, 2 and 4 load their windows 8 and
#: 16 bytes a lane
COL_CHUNK = (1, 2, 4)
UNROLL = (1, 3, 5, 15)
#: threads of a block ((block_w / col_chunk) x (block_h / row_chunk)): at
#: least four warps, and at most :func:`max_threads` of its tile
MIN_THREADS, MAX_THREADS = 128, 512
#: threads along a row of the block at least: a quarter warp's 16-byte
#: window loads then fill one 128-byte shared-memory wavefront
ROW_THREADS = 8
#: the compiled tiles, (row_chunk, col_chunk) (``CONV_TILES`` in the
#: source), at most 32 outputs a thread
TILES = ((1, 1), (2, 1), (4, 1), (8, 1), (1, 2), (2, 2), (4, 2), (8, 2),
         (1, 4), (2, 4), (4, 4), (8, 4))
#: the launch bound of the bf16 tiles of 32 outputs: 168 registers a thread
#: (at 128 the 8 x 4 tile with the filter in shared memory spilled)
WIDE_BF16_THREADS = 384
#: the filter sizes built: 15 at the reference's shape, 5 at the small one
FILTER_SIZES = (5, 15)

#: rel-L2 within which the kernel must follow :func:`conv2d_plain` on the
#: card in f32: the kernel fuses each multiply-add, which moves the result
#: by about 1.5e-7 on an H100 (PERF.md).  It sits far inside the gap that
#: the bf16 accumulator opens against f32.  With a bf16 accumulator both
#: round the same results at the same taps, and agree exactly.
PLAIN_TOL = 1e-5

SOURCE = "conv2d.cu"


def snap_unroll(u: int, extent: int) -> int:
    """The largest divisor of ``extent`` at most ``u``: the reference's
    snap of an unroll factor to the filter."""
    u = min(u, extent)
    while extent % u:
        u -= 1
    return u


def variant(f: int, unroll_fh: int, acc_dtype: str, filter_smem: int) -> str:
    """The nvcc build that holds a tile: one per (filter size, its row
    unroll, accumulator), and where the filter's rows are unrolled whole
    (the longest builds) one per filter home too, so that the builds end
    together."""
    u = snap_unroll(unroll_fh, f)
    return f"f{f}_u{u}_{acc_dtype}" + (f"_fs{filter_smem}" if u == f else "")


VARIANTS = {
    variant(f, u, acc, fs): {
        "CONV_F": f, "CONV_UFH": snap_unroll(u, f),
        "CONV_ACC_BF16": int(acc == "bf16"),
        **({"CONV_FSMEM": fs} if snap_unroll(u, f) == f else {})}
    for f in FILTER_SIZES for u in UNROLL for acc in ("f32", "bf16")
    for fs in (0, 1)}
_libs: dict[str, ctypes.CDLL] | None = None


def threads(block_h, block_w, row_chunk, col_chunk):
    """Threads of one block (works on numpy columns too)."""
    return (block_w // col_chunk) * (block_h // row_chunk)


def max_threads(row_chunk, col_chunk, acc_dtype):
    """The most threads a block of this tile may have: its launch bound
    (``CONV_MAX_THREADS`` in the source), the register budget of its
    threads, 65536 / bound registers each (works on numpy columns too)."""
    wide = (np.asarray(acc_dtype) == "bf16") & (row_chunk * col_chunk >= 32)
    return np.where(wide, WIDE_BF16_THREADS, MAX_THREADS)



def pitch(block_w, f):
    """Floats a staged row takes: ``block_w + f - 1``, padded to a multiple
    of 4 so that every row starts 16-byte aligned."""
    return -(-(block_w + f - 1) // 4) * 4


def smem_bytes(block_h, block_w, f, filter_smem):
    """Dynamic shared memory of one block: the input tile with its halo at
    the padded pitch, and with ``filter_smem`` the filter, its rows padded
    to a multiple of 4 words."""
    return ((block_h + f - 1) * pitch(block_w, f)
            + filter_smem * f * (-(-f // 4) * 4)) * 4


def loads_per_fma(cfg: dict, f: int) -> float:
    """Shared-memory words a thread reads per FMA: each chunk of
    ``unroll_fh`` filter rows reads ``row_chunk + unroll_fh - 1`` input
    rows, each column chunk of ``unroll_fw`` taps a window of ``col_chunk +
    unroll_fw - 1`` values; with ``filter_smem`` each (input row, output
    row) pair also reads its filter row, one word per ``col_chunk`` FMAs."""
    ry, rx = cfg["row_chunk"], cfg["col_chunk"]
    uh, uw = snap_unroll(cfg["unroll_fh"], f), snap_unroll(cfg["unroll_fw"], f)
    image = (ry + uh - 1) * (rx + uw - 1) / (ry * rx * uh * uw)
    return image + cfg["filter_smem"] / rx


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv_launch.argtypes = [p, p, p, p, *[i] * 12, p]
    lib.conv_launch.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.conv_attributes.argtypes = [i, i, i, i, ip, ip, ip]
    lib.conv_attributes.restype = i
    lib.conv_error_string.argtypes = [i]
    lib.conv_error_string.restype = ctypes.c_char_p
    return lib


def libraries() -> dict[str, ctypes.CDLL]:
    """The conv2d libraries by variant name (:func:`variant`), built on
    first call."""
    global _libs
    if _libs is None:
        built = _build.build(SOURCE, VARIANTS)
        _libs = {v: _bind(ctypes.CDLL(str(path)))
                 for v, path in built.libs.items()}
    return _libs


def _lib(f: int, unroll_fh: int, acc_dtype: str,
         filter_smem: int) -> ctypes.CDLL:
    if f not in FILTER_SIZES:
        raise ValueError(f"conv2d: the kernel is built for filters of "
                         f"{FILTER_SIZES}, not {f}")
    return libraries()[variant(f, unroll_fh, acc_dtype, filter_smem)]


def tile_attributes(f: int, unroll_fh: int, row_chunk: int, col_chunk: int,
                    unroll_fw: int, acc_dtype: str, filter_smem: int) -> dict:
    """Registers per thread, local (spill) bytes and the most threads a
    block may have, of one compiled tile, from ``cudaFuncGetAttributes``."""
    lib = _lib(f, unroll_fh, acc_dtype, filter_smem)
    regs, local, most = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.conv_attributes(row_chunk, col_chunk, snap_unroll(unroll_fw, f),
                              filter_smem, ctypes.byref(regs),
                              ctypes.byref(local), ctypes.byref(most))
    if err:
        raise RuntimeError(f"no compiled conv2d tile f={f} unroll_fh="
                           f"{unroll_fh} row_chunk={row_chunk} col_chunk="
                           f"{col_chunk} unroll_fw={unroll_fw} {acc_dtype} "
                           f"filter_smem={filter_smem}: "
                           f"{lib.conv_error_string(err).decode()}")
    return {"regs": regs.value, "local_bytes": local.value,
            "max_threads": most.value}


def launch(image: torch.Tensor, filt: torch.Tensor, out: torch.Tensor,
           cfg: dict) -> None:
    """Launch the kernel on the current stream.  The caller checks devices,
    dtypes, shapes and contiguity."""
    f = filt.shape[0]
    lib = _lib(f, cfg["unroll_fh"], cfg["acc_dtype"], cfg["filter_smem"])
    h, w = image.shape
    # the filter packed as bf16 pairs, which the constant copy reads
    scratch = torch.empty(f * f, dtype=torch.int32, device=image.device) \
        if cfg["acc_dtype"] == "bf16" and not cfg["filter_smem"] else None
    with torch.cuda.device(image.device):
        err = lib.conv_launch(
            image.data_ptr(), filt.data_ptr(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            h, w, f, f,
            cfg["block_h"], cfg["block_w"], cfg["row_chunk"],
            cfg["col_chunk"], snap_unroll(cfg["unroll_fh"], f),
            snap_unroll(cfg["unroll_fw"], f),
            int(cfg["acc_dtype"] == "bf16"), int(cfg["filter_smem"]),
            torch.cuda.current_stream(image.device).cuda_stream)
    if err:
        raise RuntimeError(f"conv2d kernel launch failed: "
                           f"{lib.conv_error_string(err).decode()} "
                           f"(config {cfg})")


def conv2d_plain(image: torch.Tensor, filt: torch.Tensor, *, acc_dtype: str,
                 **_tiling) -> torch.Tensor:
    """The kernel's function in PyTorch ops: (H, W) and (FH, FW) ->
    (H - FH + 1, W - FW + 1) f32.  ``_tiling`` (block_h, block_w,
    row_chunk, col_chunk, unroll_fh, unroll_fw, filter_smem) does not change
    the result."""
    fh, fw = filt.shape
    oh, ow = image.shape[0] - fh + 1, image.shape[1] - fw + 1
    acc_t = torch.float32 if acc_dtype == "f32" else torch.bfloat16
    img, fil = image.to(acc_t), filt.to(acc_t)
    acc = torch.zeros((oh, ow), dtype=acc_t, device=image.device)
    for i in range(fh):
        for j in range(fw):
            acc = acc + img[i:i + oh, j:j + ow] * fil[i, j]
    return acc.float()
