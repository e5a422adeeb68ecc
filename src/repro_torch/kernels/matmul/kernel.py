"""The Hopper GEMM: its ctypes launcher and its plain PyTorch version.

The kernel is ``csrc/gemm.cu`` (CUDA C++ for sm_90a, WMMA bf16 fragments on
the tensor cores, cp.async double buffering); it replaces the Pallas TPU
kernel ``repro/kernels/matmul/kernel.py::gemm``.  It is built with ``nvcc``
at the first launch (:mod:`repro_torch._build`), one library per
(``rhs_layout``, ``block_k``) pair, and bound with :mod:`ctypes`.

:func:`gemm_plain` computes the same function with PyTorch ops, step for
step as the kernel does: a running accumulator stored in ``acc_dtype``
between k blocks, each k block consumed as ``unroll_k`` f32 sub-dots,
``alpha`` (and ``beta * C`` when ``beta != 0``) applied in f32, and split-k
slices each rounded to the output dtype and summed in f32 by
:func:`combine_split`.  It is what CPU tensors run, and what the kernel is
held against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build

#: the tile menu compiled into the libraries (``csrc/gemm.cu`` GEMM_TILES
#: instantiates every (block_m, block_n, warps) within the accumulator
#: budget; ``space.py`` admits exactly those)
BLOCK_MN = (64, 128, 256)
BLOCK_K = (32, 64)
WARPS = (4, 8)
UNROLL_K = (1, 2)
#: f32 accumulators one thread may hold (``MAX_ACC`` in the source)
MAX_ACC_PER_THREAD = 128
#: shared-memory layout of the source: two stages, 8 bf16 of row padding,
#: a 16x16 f32 epilogue tile per warp
STAGES, PAD = 2, 8

#: rel-L2 within which the kernel must follow :func:`gemm_plain` on the
#: card.  Both sum the same f32 products, in another order, so only an
#: occasional bf16 rounding of the output differs.  It sits well inside
#: the gap that the per-k-block bf16 rounding of ``acc_dtype="bf16"`` opens
#: against an f32 accumulator, so a kernel that skipped that rounding fails.
PLAIN_TOL = 1e-3

SOURCE = "gemm.cu"
#: one nvcc build per (layout, block_k) pair
VARIANTS = {f"{layout}_bk{bk}": {"GEMM_NK": int(layout == "nk"),
                                 "GEMM_BK": bk}
            for layout in ("kn", "nk") for bk in BLOCK_K}
_libs: dict[str, ctypes.CDLL] | None = None


def smem_bytes(block_m, block_n, block_k, warps, nk):
    """Dynamic shared memory of one block, as ``Tile::SMEM`` counts it.
    Works elementwise on numpy columns too (``nk`` a bool column)."""
    b_elems = (nk * (block_n * (block_k + PAD))
               + (1 - nk) * (block_k * (block_n + PAD)))
    return (STAGES * (block_m * (block_k + PAD) + b_elems) * 2
            + warps * 256 * 4)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gemm_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, i,
                                f, f, p]
    lib.gemm_launch.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.gemm_attributes.argtypes = [i, i, i, ip, ip, ip]
    lib.gemm_attributes.restype = i
    lib.gemm_error_string.argtypes = [i]
    lib.gemm_error_string.restype = ctypes.c_char_p
    return lib


def libraries() -> dict[str, ctypes.CDLL]:
    """The four GEMM libraries, built on first call."""
    global _libs
    if _libs is None:
        built = _build.build(SOURCE, VARIANTS)
        _libs = {v: _bind(ctypes.CDLL(str(p))) for v, p in built.libs.items()}
    return _libs


def _lib(rhs_layout: str, block_k: int) -> ctypes.CDLL:
    return libraries()[f"{rhs_layout}_bk{block_k}"]


def tile_attributes(rhs_layout: str, block_m: int, block_n: int,
                    block_k: int, warps: int) -> dict:
    """Registers per thread, local (spill) bytes and dynamic shared memory
    of one compiled tile, from ``cudaFuncGetAttributes``."""
    lib = _lib(rhs_layout, block_k)
    regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.gemm_attributes(block_m, block_n, warps, ctypes.byref(regs),
                              ctypes.byref(local), ctypes.byref(smem))
    if err:
        raise RuntimeError(f"no compiled GEMM tile {block_m}x{block_n}x"
                           f"{block_k} warps={warps} {rhs_layout}: "
                           f"{lib.gemm_error_string(err).decode()}")
    return {"regs": regs.value, "local_bytes": local.value,
            "smem_bytes": smem.value}


def launch(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
           out: torch.Tensor, cfg: dict, alpha: float, beta: float) -> None:
    """Launch the kernel on the current stream: ``out`` is (M, N), or
    (split_k, M, N) for split-k (then ``beta`` must be 0).  The caller
    checks devices, dtypes, shapes and contiguity."""
    lib = _lib(cfg["rhs_layout"], cfg["block_k"])
    m, k = a.shape
    n = c.shape[1]
    with torch.cuda.device(a.device):
        err = lib.gemm_launch(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(),
            m, n, k, cfg["split_k"], cfg["block_m"], cfg["block_n"],
            cfg["warps"], int(cfg["acc_dtype"] == "bf16"), cfg["unroll_k"],
            int(cfg["grid_order"] == "nm"), alpha, beta,
            torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"GEMM kernel launch failed: "
                           f"{lib.gemm_error_string(err).decode()} "
                           f"(config {cfg})")


def combine_split(parts: torch.Tensor, c: torch.Tensor,
                  beta: float) -> torch.Tensor:
    """Sum split-k slices (each already ``alpha * partial`` in c's dtype) in
    f32, in slice order, add ``beta * C`` and cast — the reference's
    ``sum(parts)`` outside the kernel."""
    out = parts[0].float()
    for p in parts[1:]:
        out = out + p.float()
    if beta != 0.0:
        out = out + beta * c.float()
    return out.to(c.dtype)


def gemm_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
               block_k: int, unroll_k: int, split_k: int, acc_dtype: str,
               rhs_layout: str, alpha: float = 1.0, beta: float = 1.0,
               **_tiling) -> torch.Tensor:
    """The kernel's function in PyTorch ops.  ``b`` is (K, N) for
    ``rhs_layout="kn"`` and (N, K) for ``"nk"``; ``_tiling`` (block_m,
    block_n, warps, grid_order) does not change the result."""
    b_kn = b if rhs_layout == "kn" else b.t()
    m, k = a.shape
    ks = k // split_k
    step = block_k // unroll_k
    acc_t = torch.float32 if acc_dtype == "f32" else torch.bfloat16

    def one_slice(k_lo: int, beta_s: float) -> torch.Tensor:
        acc = torch.zeros((m, b_kn.shape[1]), dtype=acc_t, device=a.device)
        for k0 in range(k_lo, k_lo + ks, block_k):
            acc32 = acc.float()
            for u in range(unroll_k):
                lo = k0 + u * step
                acc32 = acc32 + a[:, lo:lo + step].float() \
                    @ b_kn[lo:lo + step].float()
            acc = acc32.to(acc_t)
        res = alpha * acc.float()
        if beta_s != 0.0:
            res = res + beta_s * c.float()
        return res.to(c.dtype)

    if split_k == 1:
        return one_slice(0, beta)
    parts = torch.stack([one_slice(s * ks, 0.0) for s in range(split_k)])
    return combine_split(parts, c, beta)
