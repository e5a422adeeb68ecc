"""The Hopper Hotspot stencil: its ctypes launcher and its plain PyTorch
version.

The kernel is ``csrc/hotspot.cu`` (CUDA C++ for sm_90a: temporal blocking
with the tile in registers.  A block computes its output tile with a halo
``tt`` deep in whole warps, a lane owning ``ROWS`` rows x C columns of it in
registers across the launch's ``tt`` sweeps; only the edges of a lane's
block move, by shuffles across lanes and through shared memory across
warps, one barrier a sweep; the C launcher issues the ceil(n / tt)
launches of one call); it replaces the Pallas TPU kernel
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

#: the menus the library launches; ``space.py`` admits exactly what it
#: launches
BLOCK_H = (8, 16, 32, 64, 128)
BLOCK_W = (8, 16, 32, 64, 128)
TT = tuple(range(1, 11))
#: sweeps per unrolled chunk: 2 keeps the edge buffers' parity static; at
#: 5 columns a lane two sweeps unrolled spill, so only 1 is compiled there
UNROLL_T = (1, 2)
WIDE_UNROLL_T = (1,)
#: rows of a lane's register block (``HOT_ROWS``), and the compiled columns
#: a lane may own (``HOT_TILES``): a warp spans 32 to 160 columns, and
#: block_w + 2 tt of the menus is never 4 warp widths
ROWS, COLS = 8, (1, 2, 3, 5)
#: the most threads a block of C columns a lane may have
#: (``HOT_MAX_THREADS(C)``, the kernel's ``__launch_bounds__``): the
#: register file (65 536) over the registers its lanes need
MAX_THREADS = {1: 768, 2: 640, 3: 512, 5: 352}

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


def cols(block_w, tt):
    """Columns a lane owns: the tile with its halo, ``block_w + 2 tt``
    wide, over the warp's 32 lanes (works on numpy columns too)."""
    return -(-(block_w + 2 * tt) // 32)


def warps(block_h, tt):
    """Warps of a block, stacked: the tile with its halo, ``block_h + 2
    tt`` tall, over ``ROWS`` rows a lane."""
    return -(-(block_h + 2 * tt) // ROWS)


def fits(block_h, block_w, tt):
    """Whether the tile with its halo fits the compiled menu and the
    register budget: C columns a lane of ``COLS`` and at most
    ``MAX_THREADS[C]`` threads (works on numpy columns too)."""
    c = np.minimum(cols(block_w, tt), max(COLS) + 1)
    most = np.array([MAX_THREADS.get(k, 0) for k in range(max(COLS) + 2)])
    return 32 * warps(block_h, tt) <= most[c]


def compiled(block_w, tt, unroll_t):
    """Whether a tile of these columns a lane is compiled at ``unroll_t``:
    at 5 columns only unroll_t 1 (works on numpy columns too)."""
    return (cols(block_w, tt) < max(COLS)) | (unroll_t == 1)


def tiles() -> list[tuple[int, int, str, int]]:
    """Every compiled (columns a lane, unroll_t, acc_dtype, power_smem)."""
    return [(c, u, a, ps) for c in COLS
            for u in (WIDE_UNROLL_T if c == max(COLS) else UNROLL_T)
            for a in ("f32", "bf16") for ps in (0, 1)]


def tile_configs() -> list[dict]:
    """One admitted config for each compiled tile, in :func:`tiles`'s
    order: tt 4 (so a run of 4k sweeps launches only that tile), block_w
    giving its columns a lane, block_h and grid_order cycled."""
    width = {1: 16, 2: 32, 3: 64, 5: 128}
    return [{"block_h": BLOCK_H[i % 4], "block_w": width[c], "tt": 4,
             "unroll_t": u, "acc_dtype": a, "power_smem": ps,
             "grid_order": ("rm", "cm")[i % 2]}
            for i, (c, u, a, ps) in enumerate(tiles())]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hotspot_launch.argtypes = [p, p, p, p, *[i] * 10, *[f] * 5, p]
    lib.hotspot_launch.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.hotspot_attributes.argtypes = [i, i, i, i, ip, ip, ip]
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


def tile_attributes(c: int, unroll_t: int, acc_dtype: str,
                    power_smem: int) -> dict:
    """Registers per thread, local (spill) bytes and the most threads a
    block may have, of one compiled tile (``c`` columns a lane), from
    ``cudaFuncGetAttributes``."""
    lib = library()
    regs, local, most = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.hotspot_attributes(c, unroll_t, int(acc_dtype == "bf16"),
                                 power_smem, ctypes.byref(regs),
                                 ctypes.byref(local), ctypes.byref(most))
    if err:
        raise RuntimeError(f"no compiled hotspot tile cols={c} unroll_t="
                           f"{unroll_t} {acc_dtype} power_smem={power_smem}: "
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
