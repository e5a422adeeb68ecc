"""Public N-body op: the Hopper kernel for CUDA tensors, the plain version for
CPU tensors, a count of kernel launches (``nbody.launches``, one a call) and
one of the CUDA kernels the calls issue (``nbody.device_launches``, also one
a call).  With no config from the caller it runs :data:`DEFAULT_CONFIG` where
that fits the shape, else the nearest config the space admits there
(:func:`~repro_torch.kernels.common.resolve_config`); where none fits, the
CPU runs the plain version with the default and a CUDA tensor raises."""

from __future__ import annotations

import torch

from ...device import HOPPER
from ..common import resolve_config
from . import kernel

#: measured over the whole ``nbody_h100`` space at the default shape on an
#: H100 (see PERF.md): the fastest SoA config with f32 and both blocks at
#: most 512, so that it fits every N that is a multiple of 512; the fastest
#: overall (block_j 4096) was 0.5 % faster.
DEFAULT_CONFIG = {"block_i": 512, "block_j": 512, "layout": "soa",
                  "unroll_j": 8, "rsqrt_method": "approx",
                  "compute_dtype": "f32"}
#: what a resolved config keeps of the default: its layout and arithmetic
SEMANTIC = ("layout", "rsqrt_method", "compute_dtype")


def check_operands(pos: torch.Tensor, mass: torch.Tensor | None,
                   layout: str) -> int:
    """Raise ValueError unless the operands fit the op: f32, contiguous, on
    one device; ``pos`` (3, N) with ``mass`` (N,) for layout "soa", the (N,
    4) bodies with no ``mass`` for "aos".  Returns N."""
    aos = layout == "aos"
    ts = (("pos", pos),) if aos else (("pos", pos), ("mass", mass))
    if aos and mass is not None:
        raise ValueError("nbody: layout 'aos' takes the (N, 4) bodies and "
                         "no mass")
    for name, t in ts:
        if t is None or not t.is_contiguous() or t.dtype != torch.float32:
            raise ValueError(f"nbody: {name} must be a contiguous f32 tensor")
        if t.device != pos.device:
            raise ValueError(f"nbody: {name} is on {t.device}, pos on "
                             f"{pos.device}")
    n = pos.shape[0] if aos else pos.shape[-1]
    want = [(n, 4)] if aos else [(3, n), (n,)]
    if [tuple(t.shape) for _, t in ts] != want:
        raise ValueError(f"nbody: shapes {[tuple(t.shape) for _, t in ts]} "
                         f"do not fit layout {layout!r}")
    return n


def check(pos: torch.Tensor, mass: torch.Tensor | None, cfg: dict) -> None:
    """Raise ValueError unless the operands and config fit the kernel: the
    operands as :func:`check_operands` says; ``block_i`` and ``block_j``
    within the menus and dividing N, ``unroll_j`` dividing ``block_j``."""
    n = check_operands(pos, mass, cfg["layout"])
    bi, bj, uj = cfg["block_i"], cfg["block_j"], cfg["unroll_j"]
    if bi not in kernel.BLOCK_I or bj not in kernel.BLOCK_J \
            or uj not in kernel.UNROLL_J or n % bi or n % bj or bj % uj \
            or cfg["rsqrt_method"] not in ("exact", "approx") \
            or cfg["compute_dtype"] not in ("f32", "bf16"):
        raise ValueError(
            f"nbody: config {cfg} does not fit N={n} (block_i one of "
            f"{kernel.BLOCK_I}, block_j one of {kernel.BLOCK_J}, both "
            f"dividing N, unroll_j one of {kernel.UNROLL_J})")


def nbody(pos: torch.Tensor, mass: torch.Tensor | None = None,
          config: dict | None = None) -> torch.Tensor:
    """Accelerations (3, N) of the bodies under ``config`` (completed from
    :data:`DEFAULT_CONFIG`; with none, the one it resolves at this N):
    ``pos`` (3, N) and ``mass`` (N,) for layout "soa", or the (N, 4) bodies
    (:func:`kernel.to_aos`) for "aos".  CUDA tensors run the kernel, or
    raise; CPU tensors run :func:`kernel.nbody_plain`."""
    if config:
        cfg = dict(DEFAULT_CONFIG, **config)
        check(pos, mass, cfg)
    else:
        from .space import build_space  # space.py imports this module
        n = check_operands(pos, mass, DEFAULT_CONFIG["layout"])
        cfg = resolve_config("nbody", build_space, {"n": n}, DEFAULT_CONFIG,
                             SEMANTIC, pos.device)
    if pos.device.type == "cpu":
        return kernel.nbody_plain(pos, mass, **cfg)
    if pos.device.type != "cuda":
        raise ValueError(f"nbody: no kernel for device {pos.device}")
    if torch.cuda.get_device_capability(pos.device) != HOPPER:
        raise ValueError(f"nbody: the kernel is built for sm_90a; "
                         f"{torch.cuda.get_device_name(pos.device)} is not")
    n = pos.shape[0] if cfg["layout"] == "aos" else pos.shape[1]
    out = torch.empty((3, n), dtype=torch.float32, device=pos.device)
    kernel.launch(pos, mass, out, cfg)
    nbody.launches += 1
    nbody.device_launches += 1
    return out


nbody.launches = 0
nbody.device_launches = 0
