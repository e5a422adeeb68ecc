"""The Hopper GEMM: its ctypes launcher and its plain PyTorch version.

The kernel is ``csrc/gemm.cu`` (CUDA C++ for sm_90a: a warp-specialised
producer keeps TMA loads in flight into a ring of ``stages`` mbarrier-guarded
shared-memory buffers, and one or two consumer warpgroups run ``wgmma`` on
them, with the building blocks in ``csrc/hopper.cuh``); it replaces the
Pallas TPU kernel ``repro/kernels/matmul/kernel.py::gemm``.  It is built with ``nvcc``
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

BLOCK_MN = (64, 128, 256)
BLOCK_K = (32, 64)
#: consumer warps: one or two warpgroups of four (the producer warpgroup
#: comes on top)
WARPS = (4, 8)
UNROLL_K = (1, 2)
#: depths of the TMA ring (``MAX_STAGES`` in the source bounds them)
STAGES = (2, 3, 4)
#: f32 accumulators one consumer thread may hold (``MAX_ACC`` in the source)
MAX_ACC_PER_THREAD = 128
#: the (block_m, block_n, warps) tiles ``GEMM_TILES`` in ``csrc/gemm.cu``
#: instantiates: whole 64-row wgmmas of N 64, 128 or 256 per consumer
#: warpgroup (two split block_m >= 128 by rows, else block_n by columns)
#: within the accumulator budget.  ``space.py`` admits exactly these.
TILES = ((64, 64, 4), (64, 128, 4), (64, 128, 8), (64, 256, 4), (64, 256, 8),
         (128, 64, 4), (128, 64, 8), (128, 128, 4), (128, 128, 8),
         (128, 256, 8), (256, 64, 4), (256, 64, 8), (256, 128, 8))
#: shared memory besides the ring: alignment slack for the 1024-byte
#: swizzle atoms, and a full and an empty mbarrier (8 B) for each of up to
#: four stages
SMEM_ALIGN, SMEM_BARRIERS = 1024, 2 * 4 * 8

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


def smem_bytes(block_m, block_n, block_k, stages):
    """Dynamic shared memory of one block, as ``Tile::smem`` counts it: a
    ring of ``stages`` A and B tiles in bf16, the alignment slack and the
    barriers.  Works elementwise on numpy columns too."""
    return (SMEM_ALIGN + stages * (block_m + block_n) * block_k * 2
            + SMEM_BARRIERS)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gemm_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, i, i,
                                f, f, p]
    lib.gemm_launch.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.gemm_attributes.argtypes = [i, i, i, i, ip, ip, ip]
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
                    block_k: int, warps: int, stages: int) -> dict:
    """Registers per thread at entry, local (spill) bytes from
    ``cudaFuncGetAttributes``, and the dynamic shared memory of one compiled
    tile with ``stages`` buffers."""
    lib = _lib(rhs_layout, block_k)
    regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.gemm_attributes(block_m, block_n, warps, stages,
                              ctypes.byref(regs), ctypes.byref(local),
                              ctypes.byref(smem))
    if err:
        raise RuntimeError(f"no compiled GEMM tile {block_m}x{block_n}x"
                           f"{block_k} warps={warps} stages={stages} "
                           f"{rhs_layout}: "
                           f"{lib.gemm_error_string(err).decode()}")
    return {"regs": regs.value, "local_bytes": local.value,
            "smem_bytes": smem.value}


def launch(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
           out: torch.Tensor, cfg: dict, alpha: float, beta: float) -> None:
    """Launch the kernel on the current stream: ``out`` is (M, N), or
    (split_k, M, N) for split-k (then ``beta`` must be 0).  The caller
    checks devices, dtypes, shapes and contiguity; the launcher refuses
    (and this raises on) what TMA cannot read: a base or row not 16-byte
    aligned."""
    lib = _lib(cfg["rhs_layout"], cfg["block_k"])
    m, k = a.shape
    n = c.shape[1]
    with torch.cuda.device(a.device):
        err = lib.gemm_launch(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(),
            m, n, k, cfg["split_k"], cfg["block_m"], cfg["block_n"],
            cfg["warps"], cfg["stages"], int(cfg["acc_dtype"] == "bf16"),
            cfg["unroll_k"],
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
    block_n, warps, stages, grid_order) does not change the result."""
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
