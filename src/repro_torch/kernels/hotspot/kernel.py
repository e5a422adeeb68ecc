"""The Hopper Hotspot stencil: its ctypes launcher and its plain PyTorch
version.

The kernel is ``csrc/hotspot.cu`` (CUDA C++ for sm_90a: a block stages its
output tile's input, a halo ``tt`` deep, in shared memory and sweeps it
there ``tt`` times; the C launcher issues the ceil(n / tt) launches of one
call); it replaces the Pallas TPU kernel
``repro/kernels/hotspot/kernel.py::hotspot_step``, the edge pad and halo
gather outside it, and its driver ``hotspot``.  It is built with ``nvcc``
at the first launch (:mod:`repro_torch._build`), one library, and bound
with :mod:`ctypes`.

:func:`hotspot_plain` computes the same function with PyTorch ops, step for
step as the kernel does: n sweeps over the whole domain, the edge cells
standing in for the neighbours beyond the domain; with ``acc_dtype="bf16"``
temperature, power and the five constants rounded to bf16 and every
operation rounded to bf16 in the order the reference's expression parses.
It is what CPU tensors run, and what the kernel is held against on the
card, on the whole domain: the kernel's tile interiors are exact
everywhere, not only on the reference's central crop.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import _build
from .ref import DEFAULTS, sweep

#: the menus the library launches (``csrc/hotspot.cu`` instantiates every
#: (unroll_t, acc_dtype, power_smem)); ``space.py`` admits exactly what it
#: launches
BLOCK_H = (8, 16, 32, 64, 128, 256)
BLOCK_W = (8, 16, 32, 64, 128, 256, 512, 1024)
TT = tuple(range(1, 11))
UNROLL_T = tuple(range(1, 11))
#: threads of a block (``csrc/hotspot.cu``): min(block_w, 128) along a row,
#: as many rows as fit in 512, which keeps 128 registers a thread
MAX_THREADS = 512

#: rel-L2 within which the kernel must follow :func:`hotspot_plain` on the
#: card, on the whole domain after all sweeps.  With a bf16 accumulator both
#: round the same f32 results at the same operations, so they agree
#: exactly.  With f32 the kernel fuses multiply-adds where the plain version
#: rounds each product; over the 600 sweeps of the default shape that moved
#: the result by 2.3e-8 on an H100 (PERF.md).
PLAIN_TOL = 1e-7

SOURCE = "hotspot.cu"
VARIANTS = {"all": {}}
_lib: ctypes.CDLL | None = None


def smem_bytes(block_h, block_w, tt, power_smem):
    """Dynamic shared memory of one block: two buffers of the tile with its
    halo, and the power tile with ``power_smem`` (works on numpy columns
    too)."""
    return (2 + power_smem) * (block_h + 2 * tt) * (block_w + 2 * tt) * 4


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hotspot_launch.argtypes = [p, p, p, p, *[i] * 10, *[f] * 5, p]
    lib.hotspot_launch.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.hotspot_attributes.argtypes = [i, i, i, ip, ip, ip]
    lib.hotspot_attributes.restype = i
    lib.hotspot_error_string.argtypes = [i]
    lib.hotspot_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The Hotspot library, built on first call."""
    global _lib
    if _lib is None:
        built = _build.build(SOURCE, VARIANTS)
        _lib = _bind(ctypes.CDLL(str(built.libs["all"])))
    return _lib


def tile_attributes(unroll_t: int, acc_dtype: str, power_smem: int) -> dict:
    """Registers per thread, local (spill) bytes and the most threads a
    block may have, of one compiled tile, from ``cudaFuncGetAttributes``."""
    lib = library()
    regs, local, most = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.hotspot_attributes(unroll_t, int(acc_dtype == "bf16"),
                                 power_smem, ctypes.byref(regs),
                                 ctypes.byref(local), ctypes.byref(most))
    if err:
        raise RuntimeError(f"no compiled hotspot tile unroll_t={unroll_t} "
                           f"{acc_dtype} power_smem={power_smem}: "
                           f"{lib.hotspot_error_string(err).decode()}")
    return {"regs": regs.value, "local_bytes": local.value,
            "max_threads": most.value}


def launch(temp: torch.Tensor, power: torch.Tensor, out: torch.Tensor,
           scratch: torch.Tensor, n_sweeps: int, cfg: dict) -> None:
    """Advance ``temp`` ``n_sweeps`` sweeps into ``out``, all launches on the
    current stream (``scratch`` is a second buffer of the domain's shape).
    The caller checks devices, dtypes, shapes and contiguity."""
    lib = library()
    h, w = temp.shape
    c = DEFAULTS
    with torch.cuda.device(temp.device):
        err = lib.hotspot_launch(
            temp.data_ptr(), power.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), h, w, n_sweeps, cfg["tt"], cfg["block_h"],
            cfg["block_w"], cfg["unroll_t"], int(cfg["acc_dtype"] == "bf16"),
            cfg["power_smem"], int(cfg["grid_order"] == "cm"), c["step"],
            c["rx"], c["ry"], c["rz"], c["amb"],
            torch.cuda.current_stream(temp.device).cuda_stream)
    if err:
        raise RuntimeError(f"hotspot kernel launch failed: "
                           f"{lib.hotspot_error_string(err).decode()} "
                           f"(config {cfg})")


def constants(acc_dtype: str) -> dict:
    """The five constants as the kernel takes them: rounded to f32, or to
    bf16 (``rx`` 0.1 becomes 0.10009765625), as Python floats."""
    dt = torch.float32 if acc_dtype == "f32" else torch.bfloat16
    return {k: float(torch.tensor(np.float32(v)).to(dt))
            for k, v in DEFAULTS.items()}


def hotspot_plain(temp: torch.Tensor, power: torch.Tensor, n_sweeps: int, *,
                  acc_dtype: str, **_tiling) -> torch.Tensor:
    """The kernel's function in PyTorch ops: ``n_sweeps`` sweeps of the (H,
    W) domain, (H, W) f32.  ``_tiling`` (tt, block_h, block_w, unroll_t,
    power_smem, grid_order) does not change the result."""
    dt = torch.float32 if acc_dtype == "f32" else torch.bfloat16
    t, p = temp.to(dt), power.to(dt)
    c = constants(acc_dtype)
    for _ in range(n_sweeps):
        t = sweep(t, p, **c)
    return t.float()
