"""The Hopper flash attention: its ctypes launcher and its plain PyTorch version.

The kernel is ``csrc/flash_attention.cu`` (CUDA C++ for sm_90a: a
warp-specialised producer loads Q once and keeps K and V tiles in flight by
TMA into a ring of three mbarrier-guarded shared-memory buffers; one
consumer warpgroup per 64 query rows computes S = Q K^T by ``wgmma`` from
shared memory, takes the online softmax in registers, and feeds P from
registers to the P V ``wgmma``; the building blocks are in
``csrc/hopper.cuh``, shared with the GEMM).  It replaces the Pallas TPU
kernel ``repro/kernels/attention/kernel.py::flash_attention``.  It is built
with ``nvcc`` at the first launch (:mod:`repro_torch._build`), one library
per head dimension, and bound with :mod:`ctypes`.

:func:`flash_attention_plain` computes the same function with PyTorch ops,
step for step as the kernel does: one ``block_kv`` tile at a time, the
running max and sum in f32, P as bf16 hi + lo for the P @ V product, the
output accumulator stored in ``acc_dtype`` between tiles, and, with
``skip_masked``, no update at all from a tile that even the last row of its
q tile masks.  It is what CPU tensors run, and what the kernel is held
against on the card.  It also takes shapes the blocks do not divide, with a
ragged last q tile and kv tile, as the reference's ``cdiv`` grid does.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from .ref import NEG_INF

#: the menus compiled into the libraries: ``csrc/flash_attention.cu``
#: instantiates every (block_kv, consumer warpgroups) of :data:`TILES` in
#: each head-dim build; ``space.py`` admits exactly those.
#: A block stacks ``block_h`` heads of ``block_q`` rows into whole 64-row
#: warpgroup tiles, so ``block_h * block_q`` is one of :data:`ROWS`.
HEAD_DIMS = (64, 128)
BLOCK_Q = (16, 32, 64, 128)
BLOCK_KV = (32, 64, 128)
ROWS = (64, 128)
ROWS_PER_WARPGROUP = 64
#: depth of the TMA ring (``STAGES`` in the source)
STAGES = 3
#: the (block_kv, warpgroups) of ``FA_TILES``
TILES = tuple((bkv, wg) for bkv in BLOCK_KV for wg in (1, 2))
#: shared memory besides Q and the ring: alignment slack for the 1024-byte
#: swizzle atoms, Q's mbarrier, and a full and an empty mbarrier (8 B
#: each) for K and for V of each stage
SMEM_ALIGN, SMEM_BARRIERS = 1024, (1 + 4 * STAGES) * 8
#: fragment registers one consumer thread may hold (``MAX_FRAG`` in the
#: source): S (block_kv / 2 f32), P as bf16 hi + lo pairs (block_kv / 2)
#: and the output accumulator (d / 2 f32).  192 is what d = 128 with
#: block_kv = 128 needs, within the 240 registers ``setmaxnreg`` gives a
#: consumer; chip_smoke.py checks that no tile spills.
MAX_FRAG_REGS = 192

#: rel-L2 within which the kernel must follow :func:`flash_attention_plain`
#: on the card.  Both take the same steps; the products sum in another
#: order, which flips an occasional bf16 rounding of P or of the output.  It
#: sits well inside the gap that the per-tile bf16 rounding of
#: ``acc_dtype="bf16"`` opens against an f32 accumulator.
PLAIN_TOL = 1e-3

SOURCE = "flash_attention.cu"
#: one nvcc build per head dimension
VARIANTS = {f"d{d}": {"FA_D": d} for d in HEAD_DIMS}
_libs: dict[int, ctypes.CDLL] | None = None


def block_rows(block_q, block_h):
    """Query rows of one block (works on numpy columns too)."""
    return block_h * block_q


def warpgroups(block_q, block_h):
    """Consumer warpgroups of one block, one per 64 rows."""
    return block_rows(block_q, block_h) // ROWS_PER_WARPGROUP


def smem_bytes(block_q, block_h, block_kv, d):
    """Dynamic shared memory of one block, as ``Tile::SMEM`` counts it: the
    Q tile, a ring of :data:`STAGES` K and V tiles in bf16, the alignment
    slack and the barriers.  Works elementwise on numpy columns too."""
    return (SMEM_ALIGN + block_rows(block_q, block_h) * d * 2
            + STAGES * 2 * block_kv * d * 2 + SMEM_BARRIERS)


def frag_regs(block_kv, d):
    """Fragment registers of one consumer thread (see
    :data:`MAX_FRAG_REGS`)."""
    return block_kv // 2 + block_kv // 2 + d // 2


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fa_launch.argtypes = [p, p, p, p, *[i] * 11, f, p]
    lib.fa_launch.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.fa_attributes.argtypes = [i, i, ip, ip, ip]
    lib.fa_attributes.restype = i
    lib.fa_error_string.argtypes = [i]
    lib.fa_error_string.restype = ctypes.c_char_p
    return lib


def libraries() -> dict[int, ctypes.CDLL]:
    """The attention libraries by head dimension, built on first call."""
    global _libs
    if _libs is None:
        built = _build.build(SOURCE, VARIANTS)
        _libs = {int(v[1:]): _bind(ctypes.CDLL(str(p)))
                 for v, p in built.libs.items()}
    return _libs


def tile_attributes(d: int, block_kv: int, n_warpgroups: int) -> dict:
    """Registers per thread at entry, local (spill) bytes from
    ``cudaFuncGetAttributes``, and the dynamic shared memory of one compiled
    tile."""
    lib = libraries()[d]
    regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.fa_attributes(block_kv, n_warpgroups, ctypes.byref(regs),
                            ctypes.byref(local), ctypes.byref(smem))
    if err:
        raise RuntimeError(f"no compiled attention tile d={d} block_kv="
                           f"{block_kv} warpgroups={n_warpgroups}: "
                           f"{lib.fa_error_string(err).decode()}")
    return {"regs": regs.value, "local_bytes": local.value,
            "smem_bytes": smem.value}


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, cfg: dict, causal: bool, scale: float) -> None:
    """Launch the kernel on the current stream.  The caller checks devices, dtypes, shapes,
    contiguity and that every block divides its dimension; the launcher
    refuses (and this raises on) what TMA cannot read: a base not 16-byte
    aligned."""
    hq, tq, d = q.shape
    hkv, tk, _ = k.shape
    lib = libraries()[d]
    with torch.cuda.device(q.device):
        err = lib.fa_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            hq, hkv, tq, tk, d, cfg["block_q"], cfg["block_kv"],
            cfg["block_h"], int(causal), int(cfg["skip_masked"]),
            int(cfg["acc_dtype"] == "bf16"), scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"attention kernel launch failed: "
                           f"{lib.fa_error_string(err).decode()} "
                           f"(config {cfg})")


def split_bf16(p: torch.Tensor) -> torch.Tensor:
    """``p`` as the kernel feeds it to the P @ V products: a bf16 high part
    plus the bf16 of the remainder, whose f32 sum is exact and keeps about
    16 of p's 24 mantissa bits."""
    hi = p.to(torch.bfloat16).float()
    return hi + (p - hi).to(torch.bfloat16).float()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, scale: float | None = None,
                          block_q: int, block_kv: int, skip_masked: int,
                          acc_dtype: str, **_tiling) -> torch.Tensor:
    """The kernel's function in PyTorch ops.  ``q`` is (Hq, Tq, D), ``k``
    and ``v`` (Hkv, Tk, D); q head h reads kv head ``h // (Hq // Hkv)``.
    ``scale`` defaults to ``d ** -0.5`` in f32.  ``_tiling`` (block_h)
    does not change the result.  A dimension the blocks do not
    divide ends in a shorter tile."""
    hq, tq, d = q.shape
    hkv, tk, _ = k.shape
    g = hq // hkv
    scale = float(d) ** -0.5 if scale is None else float(scale)
    acc_t = torch.float32 if acc_dtype == "f32" else torch.bfloat16
    dev = q.device
    qf = q.float()
    kf = k.float().repeat_interleave(g, dim=0)
    vf = v.float().repeat_interleave(g, dim=0)
    m = torch.full((hq, tq, 1), NEG_INF, device=dev)
    l = torch.zeros((hq, tq, 1), device=dev)
    acc = torch.zeros((hq, tq, d), dtype=acc_t, device=dev)
    off = tk - tq
    rows = torch.arange(tq, device=dev)[:, None] + off
    # per row, the last row of its q tile: a tile that even this row masks
    # is skipped for the whole q tile
    q_last = (torch.arange(tq, device=dev) // block_q * block_q
              + block_q - 1 + off)[:, None]
    neg = torch.tensor(NEG_INF, device=dev)
    for j0 in range(0, tk, block_kv):
        s = qf @ kf[:, j0:j0 + block_kv].transpose(1, 2) * scale
        if causal:
            cols = torch.arange(j0, min(j0 + block_kv, tk),
                                device=dev)[None, :]
            s = torch.where(rows >= cols, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l_new = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = split_bf16(p) @ vf[:, j0:j0 + block_kv]
        acc_new = (acc.float() * alpha + pv).to(acc_t)
        if causal and skip_masked:
            alive = q_last >= j0
            m = torch.where(alive, m_new, m)
            l = torch.where(alive, l_new, l)
            acc = torch.where(alive, acc_new, acc)
        else:
            m, l, acc = m_new, l_new, acc_new
    return (acc.float() / l.clamp_min(1e-30)).to(q.dtype)
