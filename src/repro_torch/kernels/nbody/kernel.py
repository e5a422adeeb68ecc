"""The Hopper N-body: its ctypes launcher and its plain PyTorch version.

The kernel is ``csrc/nbody.cu`` (CUDA C++ for sm_90a: one body i per
thread, the bodies j staged tile by tile in shared memory as float4, the
sums in registers); it replaces the Pallas TPU kernel
``repro/kernels/nbody/kernel.py::nbody``.  It is built with ``nvcc`` at
the first launch (:mod:`repro_torch._build`), one library, and bound with
:mod:`ctypes`.

:func:`nbody_plain` computes the same function with PyTorch ops, step for
step as the kernel does: all bodies i at once against one ``block_j`` tile
of bodies j at a time, in j order; with ``compute_dtype="bf16"`` the
positions and the three differences rounded to bf16 and the rest in f32;
the inverse cube as ``rsqrt_method`` says.  It is what CPU tensors run, and
what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from .ref import EPS2, G

#: the menus compiled into the library (``csrc/nbody.cu`` instantiates
#: every (unroll_j, rsqrt_method, compute_dtype)); ``space.py`` admits
#: exactly what it launches
BLOCK_I = (32, 64, 128, 256, 512)
BLOCK_J = (128, 256, 512, 1024, 2048, 4096)
UNROLL_J = (1, 2, 4, 8)

#: rel-L2 within which the kernel must follow :func:`nbody_plain` on the
#: card.  Both round the same values to bf16 where they round; the kernel
#: fuses multiply-adds and sums each body's N terms one after another in
#: f32, where the plain version reduces a tile at a time: 3.5e-7 apart at
#: N = 512 and 5.4e-6 at N = 131 072 on an H100 (PERF.md).  It sits far
#: inside the gap that ``compute_dtype="bf16"`` opens against f32.
PLAIN_TOL = 1e-5

SOURCE = "nbody.cu"
VARIANTS = {"all": {}}
_lib: ctypes.CDLL | None = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nbody_launch.argtypes = [p, p, p, p, *[i] * 7, f, p]
    lib.nbody_launch.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.nbody_attributes.argtypes = [i, i, i, ip, ip, ip]
    lib.nbody_attributes.restype = i
    lib.nbody_error_string.argtypes = [i]
    lib.nbody_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The N-body library, built on first call."""
    global _lib
    if _lib is None:
        built = _build.build(SOURCE, VARIANTS)
        _lib = _bind(ctypes.CDLL(str(built.libs["all"])))
    return _lib


def tile_attributes(unroll_j: int, rsqrt_method: str,
                    compute_dtype: str) -> dict:
    """Registers per thread, local (spill) bytes and the most threads a
    block may have, of one compiled tile, from ``cudaFuncGetAttributes``."""
    lib = library()
    regs, local, most = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.nbody_attributes(unroll_j, int(rsqrt_method == "exact"),
                               int(compute_dtype == "bf16"),
                               ctypes.byref(regs), ctypes.byref(local),
                               ctypes.byref(most))
    if err:
        raise RuntimeError(f"no compiled nbody tile unroll_j={unroll_j} "
                           f"{rsqrt_method} {compute_dtype}: "
                           f"{lib.nbody_error_string(err).decode()}")
    return {"regs": regs.value, "local_bytes": local.value,
            "max_threads": most.value}


def launch(pos: torch.Tensor, mass: torch.Tensor | None, out: torch.Tensor,
           cfg: dict, eps2: float = EPS2) -> None:
    """Launch the kernel on the current stream; ``pos`` is the (N, 4)
    bodies for layout "aos" (``mass`` None).  The caller checks devices,
    dtypes, shapes and contiguity."""
    lib = library()
    aos = cfg["layout"] == "aos"
    n = out.shape[1]
    ptr = pos.data_ptr()
    with torch.cuda.device(pos.device):
        err = lib.nbody_launch(
            None if aos else ptr, None if aos else mass.data_ptr(),
            ptr if aos else None, out.data_ptr(), n, cfg["block_i"],
            cfg["block_j"], cfg["unroll_j"],
            int(cfg["rsqrt_method"] == "exact"),
            int(cfg["compute_dtype"] == "bf16"), int(aos), eps2,
            torch.cuda.current_stream(pos.device).cuda_stream)
    if err:
        raise RuntimeError(f"nbody kernel launch failed: "
                           f"{lib.nbody_error_string(err).decode()} "
                           f"(config {cfg})")


def to_aos(pos: torch.Tensor, mass: torch.Tensor) -> torch.Tensor:
    """The (N, 4) bodies x, y, z, m of layout "aos"."""
    return torch.cat([pos, mass[None]]).t().contiguous()


def inv_r3(r2: torch.Tensor, method: str) -> torch.Tensor:
    """``r2 ** -1.5`` as the kernel takes it: IEEE ``1 / sqrt`` ("exact"),
    or ``rsqrt`` with one Newton step ("approx")."""
    if method == "exact":
        inv = 1.0 / torch.sqrt(r2)
    else:
        y = torch.rsqrt(r2)
        inv = y * (1.5 - 0.5 * r2 * y * y)
    return inv * inv * inv


def nbody_plain(pos: torch.Tensor, mass: torch.Tensor | None = None, *,
                block_j: int, layout: str, rsqrt_method: str,
                compute_dtype: str, eps2: float = EPS2,
                **_tiling) -> torch.Tensor:
    """The kernel's function in PyTorch ops.  ``pos`` is (3, N) with
    ``mass`` (N,) for ``layout="soa"``, and the (N, 4) bodies for "aos".
    Returns (3, N) f32.  ``_tiling`` (block_i, unroll_j) does not change
    the result."""
    if layout == "aos":
        pos, mass = pos[:, :3].t(), pos[:, 3]
    x = pos.float()
    if compute_dtype == "bf16":
        x = x.to(torch.bfloat16)
    n = x.shape[1]
    acc = torch.zeros((3, n), dtype=torch.float32, device=pos.device)
    for j0 in range(0, n, block_j):
        d = x[:, None, j0:j0 + block_j] - x[:, :, None]     # (3, i, j)
        d = d.float()
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + eps2
        w = mass[None, j0:j0 + block_j].float() * inv_r3(r2, rsqrt_method)
        acc = acc + (d * w[None]).sum(dim=2)
    return G * acc
