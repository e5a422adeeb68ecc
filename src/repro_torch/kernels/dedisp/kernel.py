"""The Hopper dedispersion: its ctypes launcher and its plain PyTorch
version.

The kernel is ``csrc/dedisp.cu`` (CUDA C++ for sm_90a: a block owns
``block_d`` DMs x ``time_chunk`` samples and walks them in passes; for each
step of ``block_c`` channels thread 0 stages, by bulk copies into a ring
of as many steps of slots as fit, completing on mbarriers, the delay
table's slice and each channel's window of x that the block's DMs read;
the warps take each step as it lands, each thread adding the samples of
its ``unroll_d`` DMs channel by channel, in registers, reading a window
once per run of equal delays among its DMs); it replaces the
Pallas TPU kernel ``repro/kernels/dedisp/kernel.py::dedisp``.  It is built with ``nvcc`` at
the first launch (:mod:`repro_torch._build`), one library, and bound with
:mod:`ctypes`.

:func:`dedisp_plain` computes the same function with PyTorch ops, step for
step as the kernel does: channel by channel in order, each channel's
shifted samples added to all outputs; with ``acc_dtype="bf16"`` the samples
and every sum rounded to bf16.  Adds in one order are the same adds, so
the kernel follows it bit for bit.  It is what CPU tensors run, and what
the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import _build
from ..common import SMEM_PER_BLOCK

#: the menus the library launches (``csrc/dedisp.cu`` instantiates every
#: (unroll_d, samples a thread) with at most ``MAX_ACC`` accumulators and
#: ``MAX_SAMPLES`` samples);
#: ``space.py`` admits exactly what it launches
BLOCK_D = (8, 16, 32, 64, 128)
BLOCK_C = (1, 2, 4, 8, 16, 32, 64)
TIME_CHUNK = (0, 256, 512, 1024, 2048, 4096, 8192)
UNROLL_D = (1, 2, 4, 8)
#: threads of a block, at most (128 registers a thread); a row of threads
#: along time is whole warps, so a block has at most 16 rows of DMs
MAX_THREADS, MIN_ROW = 512, 32
#: accumulators a thread holds in registers (unroll_d x samples), and
#: samples a thread
MAX_ACC, MAX_SAMPLES = 64, 16

#: mismatching outputs allowed between the kernel and
#: :func:`dedisp_plain` on the card: none.
PLAIN_TOL = 0.0

SOURCE = "dedisp.cu"
VARIANTS = {"all": {}}
_lib: ctypes.CDLL | None = None


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def layout(block_d: int, unroll_d: int, tc: int) -> tuple[int, int, int]:
    """(threads along time, rows of DMs, samples a thread) of one block
    owning ``block_d`` DMs x ``tc`` samples; a block walks its samples in
    passes of threads x samples.  A row is whole warps, so that a warp
    shares its DMs."""
    rows = block_d // unroll_d
    nx = min(-(-tc // 32) * 32, MAX_THREADS // rows)
    return nx, rows, min(_pow2_at_least(-(-tc // nx)), MAX_ACC // unroll_d,
                         MAX_SAMPLES)


def slot_floats(nx: int, samples: int, max_delay: int) -> int:
    """Floats of one ring slot: a pass (``nx`` x ``samples``) plus
    ``max_delay`` (T - t_out, the widest span of delays any table the op
    accepts can have), plus the 16-byte rounding at both ends of the
    window, rounded up to 16 bytes (``csrc/dedisp.cu`` ``dedisp_launch``)."""
    return (nx * samples + max_delay + 6 + 3) // 4 * 4


#: the most steps of the ring (``MAX_STAGES``); it has as many as fit, and
#: needs two
MAX_STAGES = 8


def win_bytes(c: int) -> int:
    """Each channel's least and greatest delay: 8 B a channel, the count
    rounded up to even."""
    return 8 * (c + c % 2)


def stage_bytes(block_d: int, block_c: int, slot: int) -> int:
    """One step of the ring: ``block_c`` slots of ``slot`` floats,
    ``block_c`` delay slices of ``block_d`` int32 and two mbarriers."""
    return block_c * (slot + block_d) * 4 + 16


def stages(c: int, block_d: int, block_c: int, slot: int) -> int:
    """Steps of the ring (``ring_stages``): as many as fit in a block's
    shared memory beside the channels' bounds, at most ``MAX_STAGES``."""
    return min(MAX_STAGES, (SMEM_PER_BLOCK - win_bytes(c))
               // stage_bytes(block_d, block_c, slot))


def config_stages(cfg: dict, c: int, t_out: int, t_in: int) -> int:
    """:func:`stages` of ``cfg`` at C = ``c``, ``t_out`` of ``t_in``
    samples: the config fits where it is at least 2."""
    nx, _, st = layout(cfg["block_d"], cfg["unroll_d"],
                       cfg["time_chunk"] or t_out)
    return stages(c, cfg["block_d"], cfg["block_c"],
                  slot_floats(nx, st, t_in - t_out))


def reads_per_add(delays: np.ndarray, unroll_d: int) -> float:
    """Window reads a sample-add of the kernel makes on a (C, D) delay
    table: a thread owns ``unroll_d`` consecutive DMs and reads, for each
    channel, once per run of equal delays among them (once per distinct
    delay where equal delays are adjacent, as delays grow with DM).  DMs
    past the last of a ragged group repeat its delay, as the kernel stages
    them."""
    c, d = delays.shape
    pad = -d % unroll_d
    dl = np.concatenate([delays, np.repeat(delays[:, -1:], pad, 1)], 1) \
        if pad else delays
    g = dl.reshape(c, -1, unroll_d)
    reads = 1 + (g[..., 1:] != g[..., :-1]).sum(-1)
    return float(reads.sum()) / g.size


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dedisp_launch.argtypes = [p, p, p, *[i] * 12, p]
    lib.dedisp_launch.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.dedisp_attributes.argtypes = [i, i, i, ip, ip, ip]
    lib.dedisp_attributes.restype = i
    lib.dedisp_error_string.argtypes = [i]
    lib.dedisp_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The dedispersion library, built on first call."""
    global _lib
    if _lib is None:
        built = _build.build(SOURCE, VARIANTS)
        _lib = _bind(ctypes.CDLL(str(built.libs["all"])))
    return _lib


def tile_attributes(unroll_d: int, samples: int, acc_dtype: str) -> dict:
    """Registers per thread, local (spill) bytes and the most threads a
    block may have, of one compiled tile, from ``cudaFuncGetAttributes``."""
    lib = library()
    regs, local, most = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.dedisp_attributes(unroll_d, samples, int(acc_dtype == "bf16"),
                                ctypes.byref(regs), ctypes.byref(local),
                                ctypes.byref(most))
    if err:
        raise RuntimeError(f"no compiled dedisp tile unroll_d={unroll_d} "
                           f"samples={samples} {acc_dtype}: "
                           f"{lib.dedisp_error_string(err).decode()}")
    return {"regs": regs.value, "local_bytes": local.value,
            "max_threads": most.value}


def tiles() -> list[tuple[int, int]]:
    """Every compiled (unroll_d, samples a thread)."""
    return [(u, s) for u in UNROLL_D for s in (1, 2, 4, 8, 16)
            if u * s <= MAX_ACC and s <= MAX_SAMPLES]


def launch(x: torch.Tensor, delays: torch.Tensor, out: torch.Tensor,
           cfg: dict) -> None:
    """Launch the kernel on the current stream.  The caller checks devices,
    dtypes, shapes and contiguity."""
    lib = library()
    c_dim, t_in = x.shape
    d_dim, t_out = out.shape
    bd = cfg["block_d"]
    # bulk copies move 16-byte pieces: x starts on 16 B and its last row
    # ends on 16 B; a block's slice of a delay row, bd int32 from a multiple
    # of bd, lies inside the row
    if x.data_ptr() % 16 or x.numel() % 4:
        flat = torch.empty(-(-x.numel() // 4) * 4, dtype=x.dtype,
                           device=x.device)
        flat[:x.numel()] = x.reshape(-1)
        x = flat[:x.numel()].view(c_dim, t_in)
    d_stride = -(-d_dim // bd) * bd
    if delays.data_ptr() % 16 or d_stride != d_dim:
        padded = torch.empty((c_dim, d_stride), dtype=delays.dtype,
                             device=delays.device)
        padded[:, :d_dim] = delays
        padded[:, d_dim:] = delays[:, -1:]
        delays = padded
    tc = cfg["time_chunk"] or t_out
    nx, _, samples = layout(bd, cfg["unroll_d"], tc)
    with torch.cuda.device(x.device):
        err = lib.dedisp_launch(
            x.data_ptr(), delays.data_ptr(), out.data_ptr(), c_dim, t_in,
            d_dim, d_stride, t_out, bd, cfg["block_c"], tc,
            cfg["unroll_d"], nx, samples, int(cfg["acc_dtype"] == "bf16"),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"dedisp kernel launch failed: "
                           f"{lib.dedisp_error_string(err).decode()} "
                           f"(config {cfg})")


def dedisp_plain(x: torch.Tensor, delays: torch.Tensor, t_out: int, *,
                 acc_dtype: str, **_tiling) -> torch.Tensor:
    """The kernel's function in PyTorch ops: ``x`` (C, T) and ``delays``
    (C, D) -> (D, t_out) f32, the channels added in order.  ``_tiling``
    (block_d, block_c, time_chunk, unroll_d) does not change the result."""
    dt = torch.float32 if acc_dtype == "f32" else torch.bfloat16
    xs = x.to(dt)
    ar = torch.arange(t_out, device=x.device)
    acc = torch.zeros((delays.shape[1], t_out), dtype=dt, device=x.device)
    for c in range(x.shape[0]):
        acc = acc + xs[c][delays[c].long()[:, None] + ar]
    return acc.float()
