"""The Hopper ExpDist: its ctypes launcher and its plain PyTorch version.

The kernel is ``csrc/expdist.cu`` (CUDA C++ for sm_90a: one point a_i per
thread, the j tiles staged in shared memory, f32 sums per thread, a fixed
tree per block into a (gi, njb) array of partials, and a second one-block
launch that adds the partials in a fixed order); it replaces the Pallas
TPU kernel ``repro/kernels/expdist/kernel.py::expdist``, the far-point
padding before it and the sum after it.  It is built with ``nvcc`` at the
first launch (:mod:`repro_torch._build`), one library, and bound with
:mod:`ctypes`.

:func:`expdist_plain` computes the same function with PyTorch ops, in the
kernel's arithmetic: with ``compute_dtype="bf16"`` the coordinates and the
two differences rounded to bf16 and the rest in f32; the exponential as
``exp_variant`` says.  It sums the terms in PyTorch's order (one chunk of
points a_i at a time), not the kernel's, which is what ``PLAIN_TOL``
allows for.  It is what CPU tensors run, and what the kernel is held
against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build

#: the menus the library launches (``csrc/expdist.cu`` instantiates every
#: (unroll_j, exp_variant, compute_dtype)); ``space.py`` admits exactly what
#: it launches
BLOCK_I = (32, 64, 128, 256, 512)
BLOCK_J = (128, 256, 512, 1024, 2048)
UNROLL_J = (1, 2, 4)
N_Y_BLOCKS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
#: threads of a block (``block_i``), at most 512: 128 registers a thread
MAX_THREADS = 512
LOG2E = 1.4426950408889634

#: rel error within which the kernel's sum must follow
#: :func:`expdist_plain` on the card.  Both compute the same f32 terms up
#: to the rounding of the exponential and of a fused multiply-add; the
#: kernel adds a thread's up to 65 536 terms one after another in f32,
#: where PyTorch sums pairwise: at most 1.8e-7 apart on an H100 (PERF.md),
#: the sums of different threads erring both ways.  It sits inside the gap
#: that ``compute_dtype="bf16"`` opens against f32 (4.3e-6 at the default
#: shape).
PLAIN_TOL = 1e-6
#: points a_i per step of the plain version (at most 270 MB of terms)
CHUNK = 1024

SOURCE = "expdist.cu"
VARIANTS = {"all": {}}
_lib: ctypes.CDLL | None = None


def n_col_blocks(kb: int, block_j: int, use_column: int,
                 n_y_blocks: int) -> int:
    """Column blocks of the grid: 1 with ``use_column``, else
    ``n_y_blocks`` up to the j tiles there are (the reference's njb)."""
    return 1 if use_column else max(1, min(n_y_blocks, -(-kb // block_j)))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.expdist_launch.argtypes = [p, p, p, p, p, p, *[i] * 8, p]
    lib.expdist_launch.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.expdist_attributes.argtypes = [i, i, i, ip, ip, ip]
    lib.expdist_attributes.restype = i
    lib.expdist_error_string.argtypes = [i]
    lib.expdist_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The ExpDist library, built on first call."""
    global _lib
    if _lib is None:
        built = _build.build(SOURCE, VARIANTS)
        _lib = _bind(ctypes.CDLL(str(built.libs["all"])))
    return _lib


def tile_attributes(unroll_j: int, exp_variant: str,
                    compute_dtype: str) -> dict:
    """Registers per thread, local (spill) bytes and the most threads a
    block may have, of one compiled tile, from ``cudaFuncGetAttributes``."""
    lib = library()
    regs, local, most = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.expdist_attributes(unroll_j, int(exp_variant == "exp2"),
                                 int(compute_dtype == "bf16"),
                                 ctypes.byref(regs), ctypes.byref(local),
                                 ctypes.byref(most))
    if err:
        raise RuntimeError(f"no compiled expdist tile unroll_j={unroll_j} "
                           f"{exp_variant} {compute_dtype}: "
                           f"{lib.expdist_error_string(err).decode()}")
    return {"regs": regs.value, "local_bytes": local.value,
            "max_threads": most.value}


def launch(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor,
           sb: torch.Tensor, out: torch.Tensor, cfg: dict) -> None:
    """D into the one-element ``out`` on the current stream.  The caller
    checks devices, dtypes, shapes and contiguity."""
    lib = library()
    ka, kb = a.shape[1], b.shape[1]
    bi, bj = cfg["block_i"], cfg["block_j"]
    njb = n_col_blocks(kb, bj, cfg["use_column"], cfg["n_y_blocks"])
    partial = torch.empty(-(-ka // bi) * njb, dtype=torch.float32,
                          device=a.device)
    with torch.cuda.device(a.device):
        err = lib.expdist_launch(
            a.data_ptr(), sa.data_ptr(), b.data_ptr(), sb.data_ptr(),
            partial.data_ptr(), out.data_ptr(), ka, kb, bi, bj, njb,
            cfg["unroll_j"], int(cfg["exp_variant"] == "exp2"),
            int(cfg["compute_dtype"] == "bf16"),
            torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"expdist kernel launch failed: "
                           f"{lib.expdist_error_string(err).decode()} "
                           f"(config {cfg})")


def expdist_plain(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor,
                  sb: torch.Tensor, *, exp_variant: str, compute_dtype: str,
                  **_tiling) -> torch.Tensor:
    """The kernel's function in PyTorch ops: ``a``, ``b`` (2, K) and ``sa``,
    ``sb`` (K,) -> a scalar f32.  ``_tiling`` (block_i, block_j,
    use_column, n_y_blocks, unroll_j) changes only the kernel's order of
    summation."""
    lo = compute_dtype == "bf16"
    ac = a.to(torch.bfloat16) if lo else a
    bc = b.to(torch.bfloat16) if lo else b
    sb2 = (sb * sb)[None, :]
    total = torch.zeros((), dtype=torch.float32, device=a.device)
    for s in range(0, a.shape[1], CHUNK):
        dx = (ac[0, s:s + CHUNK, None] - bc[0][None, :]).float()
        dy = (ac[1, s:s + CHUNK, None] - bc[1][None, :]).float()
        r2 = dx * dx + dy * dy
        sa2 = (sa[s:s + CHUNK] * sa[s:s + CHUNK])[:, None]
        z = -r2 / (2.0 * (sa2 + sb2))
        e = torch.exp(z) if exp_variant == "exp" else torch.exp2(z * LOG2E)
        total = total + e.sum()
    return total
