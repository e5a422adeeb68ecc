"""The Hopper 2-D convolution: its ctypes launcher and its plain PyTorch
version.

The kernel is ``csrc/conv2d.cu`` (CUDA C++ for sm_90a: a block stages its
output tile's input, halo and all, in shared memory and each thread
computes ``row_chunk`` rows of one column; the filter in shared or
``__constant__`` memory); it replaces the Pallas TPU kernel
``repro/kernels/conv2d/kernel.py::conv2d`` and the halo gather outside it.
It is built with ``nvcc`` at the first launch (:mod:`repro_torch._build`),
one library per (filter size, ``unroll_fh``), and bound with :mod:`ctypes`.

:func:`conv2d_plain` computes the same function with PyTorch ops, step for
step as the kernel does: one tap at a time, i outer and j inner; with
``acc_dtype="bf16"`` the image and filter rounded to bf16 and the product
and the running sum rounded to bf16 at every tap, as the reference
accumulates in bf16.  It is what CPU tensors run, and what the kernel is
held against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build

#: the menus compiled into the libraries (``csrc/conv2d.cu`` instantiates
#: every (row_chunk, unroll_fw, acc_dtype, filter_smem) per build);
#: ``space.py`` admits exactly what they launch
BLOCK_H = (1, 2, 4, 8, 16, 32, 64)
BLOCK_W = (16, 32, 64, 128, 256)
ROW_CHUNK = (1, 2, 4, 8)
UNROLL = (1, 3, 5, 15)
#: threads of a block (block_w * block_h / row_chunk), at least a warp and
#: at most ``MAX_THREADS`` in the source (128 registers a thread)
MIN_THREADS, MAX_THREADS = 32, 512
#: the filter sizes built: 15 at the reference's shape, 5 at the small one
FILTER_SIZES = (5, 15)

#: rel-L2 within which the kernel must follow :func:`conv2d_plain` on the
#: card.  With a bf16 accumulator both round the same f32 results at the
#: same taps; with f32 the kernel fuses each multiply-add, which moves the
#: result by about 1.5e-7 on an H100 (PERF.md).  It sits far inside the gap
#: that the bf16 accumulator opens against f32.
PLAIN_TOL = 1e-5

SOURCE = "conv2d.cu"


def snap_unroll(u: int, extent: int) -> int:
    """The largest divisor of ``extent`` at most ``u``: the reference's
    snap of an unroll factor to the filter."""
    u = min(u, extent)
    while extent % u:
        u -= 1
    return u


#: one nvcc build per (filter size, its row unroll)
VARIANTS = {f"f{f}_u{u}": {"CONV_F": f, "CONV_UFH": u}
            for f in FILTER_SIZES
            for u in sorted({snap_unroll(u, f) for u in UNROLL})}
_libs: dict[tuple[int, int], ctypes.CDLL] | None = None


def threads(block_h, block_w, row_chunk):
    """Threads of one block (works on numpy columns too)."""
    return block_w * (block_h // row_chunk)


def smem_bytes(block_h, block_w, f, filter_smem):
    """Dynamic shared memory of one block: the input tile with its halo,
    and the filter with ``filter_smem``."""
    return ((block_h + f - 1) * (block_w + f - 1) + filter_smem * f * f) * 4


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv_launch.argtypes = [p, p, p, p, *[i] * 11, p]
    lib.conv_launch.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.conv_attributes.argtypes = [i, i, i, i, ip, ip, ip]
    lib.conv_attributes.restype = i
    lib.conv_error_string.argtypes = [i]
    lib.conv_error_string.restype = ctypes.c_char_p
    return lib


def libraries() -> dict[tuple[int, int], ctypes.CDLL]:
    """The conv2d libraries by (filter size, unroll_fh), built on first
    call."""
    global _libs
    if _libs is None:
        built = _build.build(SOURCE, VARIANTS)
        _libs = {}
        for v, path in built.libs.items():
            f, u = v[1:].split("_u")
            _libs[int(f), int(u)] = _bind(ctypes.CDLL(str(path)))
    return _libs


def _lib(f: int, unroll_fh: int) -> ctypes.CDLL:
    if f not in FILTER_SIZES:
        raise ValueError(f"conv2d: the kernel is built for filters of "
                         f"{FILTER_SIZES}, not {f}")
    return libraries()[f, snap_unroll(unroll_fh, f)]


def tile_attributes(f: int, unroll_fh: int, row_chunk: int, unroll_fw: int,
                    acc_dtype: str, filter_smem: int) -> dict:
    """Registers per thread, local (spill) bytes and the most threads a
    block may have, of one compiled tile, from ``cudaFuncGetAttributes``."""
    lib = _lib(f, unroll_fh)
    regs, local, most = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.conv_attributes(row_chunk, snap_unroll(unroll_fw, f),
                              int(acc_dtype == "bf16"), filter_smem,
                              ctypes.byref(regs), ctypes.byref(local),
                              ctypes.byref(most))
    if err:
        raise RuntimeError(f"no compiled conv2d tile f={f} unroll_fh="
                           f"{unroll_fh} row_chunk={row_chunk} unroll_fw="
                           f"{unroll_fw} {acc_dtype} filter_smem="
                           f"{filter_smem}: "
                           f"{lib.conv_error_string(err).decode()}")
    return {"regs": regs.value, "local_bytes": local.value,
            "max_threads": most.value}


def launch(image: torch.Tensor, filt: torch.Tensor, out: torch.Tensor,
           cfg: dict) -> None:
    """Launch the kernel on the current stream.  The caller checks devices,
    dtypes, shapes and contiguity."""
    f = filt.shape[0]
    lib = _lib(f, cfg["unroll_fh"])
    h, w = image.shape
    # the bf16-rounded filter that the constant copy reads
    scratch = torch.empty(f * f, device=image.device) \
        if cfg["acc_dtype"] == "bf16" and not cfg["filter_smem"] else None
    with torch.cuda.device(image.device):
        err = lib.conv_launch(
            image.data_ptr(), filt.data_ptr(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            h, w, f, f,
            cfg["block_h"], cfg["block_w"], cfg["row_chunk"],
            snap_unroll(cfg["unroll_fh"], f), snap_unroll(cfg["unroll_fw"], f),
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
    row_chunk, unroll_fh, unroll_fw, filter_smem) does not change the
    result."""
    fh, fw = filt.shape
    oh, ow = image.shape[0] - fh + 1, image.shape[1] - fw + 1
    acc_t = torch.float32 if acc_dtype == "f32" else torch.bfloat16
    img, fil = image.to(acc_t), filt.to(acc_t)
    acc = torch.zeros((oh, ow), dtype=acc_t, device=image.device)
    for i in range(fh):
        for j in range(fw):
            acc = acc + img[i:i + oh, j:j + ow] * fil[i, j]
    return acc.float()
