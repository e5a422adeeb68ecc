"""The Hopper point in polygon: its ctypes launcher and its plain PyTorch
version.

The kernel is ``csrc/pnpoly.cu`` (CUDA C++ for sm_90a: one thread per point,
or several at the largest blocks, the vertices in ``__constant__`` memory,
slopes optionally precomputed per block in shared memory); it replaces the
Pallas TPU kernel ``repro/kernels/pnpoly/kernel.py::pnpoly``.  It is built
with ``nvcc`` at the first launch (:mod:`repro_torch._build`), one library
per ``between_method``, and bound with :mod:`ctypes`.

:func:`pnpoly_plain` computes the same function with PyTorch ops, step for
step as the kernel does: one edge at a time, the slope
``(x2 - x1) / (y2 - y1)`` (1 for a horizontal edge) first, the crossing
``slope * (py - y1) + x1`` rounded after each operation, the twelve
(``between_method``, ``use_method``) variants as the kernel writes them.  It
is what CPU tensors run, and what the kernel is held against on the card:
exactly, since the answer is an integer.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build

#: the menus compiled into the libraries (``csrc/pnpoly.cu`` instantiates
#: every (use_method, unroll_v, precompute_slope, points per thread));
#: ``space.py`` admits exactly those
BLOCK_POINTS = (32, 64, 128, 256, 512, 1024, 2048, 4096)
UNROLL_V = (1, 2, 3, 4, 6, 8)
BETWEEN_METHODS = (0, 1, 2, 3)
USE_METHODS = (0, 1, 2)
#: threads of a block at most (``MAX_THREADS`` in the source); larger blocks
#: give each thread block_points / 512 points
MAX_THREADS = 512
#: vertices the ``__constant__`` copy holds (``MAX_V`` in the source)
MAX_V = 4096

#: mismatches allowed between the kernel and :func:`pnpoly_plain`: none
PLAIN_TOL = 0.0

SOURCE = "pnpoly.cu"
#: one nvcc build per between_method
VARIANTS = {f"between{b}": {"PNP_BETWEEN": b} for b in BETWEEN_METHODS}
_libs: dict[int, ctypes.CDLL] | None = None


def threads(block_points: int) -> int:
    """Threads of one block."""
    return min(block_points, MAX_THREADS)


def points_per_thread(block_points: int) -> int:
    return block_points // threads(block_points)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pnp_launch.argtypes = [p, p, p, *[i] * 7, p]
    lib.pnp_launch.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.pnp_attributes.argtypes = [i, i, i, i, ip, ip, ip]
    lib.pnp_attributes.restype = i
    lib.pnp_error_string.argtypes = [i]
    lib.pnp_error_string.restype = ctypes.c_char_p
    return lib


def libraries() -> dict[int, ctypes.CDLL]:
    """The pnpoly libraries by between_method, built on first call."""
    global _libs
    if _libs is None:
        built = _build.build(SOURCE, VARIANTS)
        _libs = {int(v[len("between"):]): _bind(ctypes.CDLL(str(p)))
                 for v, p in built.libs.items()}
    return _libs


def tile_attributes(between_method: int, use_method: int, unroll_v: int,
                    precompute_slope: int, ppt: int) -> dict:
    """Registers per thread, local (spill) bytes and the most threads a
    block may have, of one compiled tile, from ``cudaFuncGetAttributes``."""
    lib = libraries()[between_method]
    regs, local, most = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.pnp_attributes(use_method, unroll_v, precompute_slope, ppt,
                             ctypes.byref(regs), ctypes.byref(local),
                             ctypes.byref(most))
    if err:
        raise RuntimeError(f"no compiled pnpoly tile between={between_method} "
                           f"use={use_method} unroll={unroll_v} pre="
                           f"{precompute_slope} ppt={ppt}: "
                           f"{lib.pnp_error_string(err).decode()}")
    return {"regs": regs.value, "local_bytes": local.value,
            "max_threads": most.value}


def launch(points: torch.Tensor, poly: torch.Tensor, out: torch.Tensor,
           cfg: dict) -> None:
    """Launch the kernel on the current stream.  The caller checks devices,
    dtypes, shapes and contiguity."""
    lib = libraries()[cfg["between_method"]]
    aos = cfg["coord_layout"] == "aos"
    n = points.shape[0] if aos else points.shape[1]
    with torch.cuda.device(points.device):
        err = lib.pnp_launch(
            points.data_ptr(), poly.data_ptr(), out.data_ptr(), n,
            poly.shape[1], cfg["block_points"], cfg["use_method"],
            cfg["unroll_v"], cfg["precompute_slope"], int(aos),
            torch.cuda.current_stream(points.device).cuda_stream)
    if err:
        raise RuntimeError(f"pnpoly kernel launch failed: "
                           f"{lib.pnp_error_string(err).decode()} "
                           f"(config {cfg})")


def between(y1, y2, py, method: int) -> torch.Tensor:
    """Whether ``py`` lies between the edge's ends, as variant ``method``
    of the kernel tests it (see ``csrc/pnpoly.cu``)."""
    gt1, gt2 = y1 > py, y2 > py
    if method == 0:
        return gt1 != gt2
    if method == 1:
        p = (y1 - py) * (y2 - py)
        return (p < 0) | ((p == 0) & (gt1 != gt2))
    if method == 2:
        return (gt1.int() - gt2.int()).abs() == 1
    return (torch.minimum(y1, y2) <= py) & (py < torch.maximum(y1, y2))


def pnpoly_plain(points: torch.Tensor, poly: torch.Tensor, *,
                 between_method: int, use_method: int, coord_layout: str,
                 **_tiling) -> torch.Tensor:
    """The kernel's function in PyTorch ops.  ``points`` is (2, N) for
    ``coord_layout="soa"`` and (N, 2) for ``"aos"``; ``poly`` is (2, V).
    Returns int32 (N,).  ``_tiling`` (block_points, unroll_v,
    precompute_slope) does not change the result: a precomputed slope is
    the same division."""
    px, py = (points[0], points[1]) if coord_layout == "soa" \
        else (points[:, 0], points[:, 1])
    xs, ys = poly[0], poly[1]
    v = poly.shape[1]
    if use_method == 0:
        acc = torch.zeros_like(px, dtype=torch.bool)
    elif use_method == 1:
        acc = torch.zeros_like(px, dtype=torch.int32)
    else:
        acc = torch.ones_like(px)
    for e in range(v):
        x1, y1 = xs[e], ys[e]
        x2, y2 = xs[(e + 1) % v], ys[(e + 1) % v]
        den = y2 - y1
        slope = (x2 - x1) / torch.where(den == 0, torch.ones_like(den), den)
        cross = between(y1, y2, py, between_method) & (px < slope * (py - y1)
                                                       + x1)
        if use_method == 0:
            acc = acc ^ cross
        elif use_method == 1:
            acc = acc + cross.int()
        else:
            acc = acc * torch.where(cross, -1.0, 1.0)
    if use_method == 0:
        return acc.int()
    if use_method == 1:
        return (acc % 2).int()
    return (acc < 0).int()
