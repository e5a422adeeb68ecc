"""Public ExpDist op: the Hopper kernel for CUDA tensors, the plain version for
CPU tensors, a count of kernel launches (``expdist.launches``, one a call)
and one of the CUDA kernels the calls issue (``expdist.device_launches``:
two a call, the kernel and the partials' sum, both issued from C).  With no
config from the caller it runs :data:`DEFAULT_CONFIG` where that fits the
shape, else the nearest config the space admits there
(:func:`~repro_torch.kernels.common.resolve_config`: at a small kb, fewer
column blocks than the default's 64; one column block fits every kb)."""

from __future__ import annotations

import torch

from ...device import HOPPER
from ..common import resolve_config
from . import kernel

#: from the ``expdist_h100`` space measured whole (2700 configs) at the
#: default shape on an H100 (see PERF.md): 512 points a_i a block, j tiles
#: of 256 split over 64 columns of blocks, exp2, f32; 0.7 % behind the
#: fastest (tiles of 512 over 128 columns), and admitted by the space from
#: kb = 16 384 up, where the fastest needs all 65 536.  Fewer j tiles than
#: columns cut the columns.
DEFAULT_CONFIG = {"block_i": 512, "block_j": 256, "use_column": 0,
                  "n_y_blocks": 64, "unroll_j": 4, "exp_variant": "exp2",
                  "compute_dtype": "f32"}
#: what a resolved config keeps of the default: its arithmetic
SEMANTIC = ("exp_variant", "compute_dtype")


def check(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor,
          sb: torch.Tensor, cfg: dict) -> None:
    """Raise ValueError unless the operands and config fit the kernel: f32,
    contiguous, on one device; ``a`` (2, ka), ``b`` (2, kb), ``sa`` (ka,),
    ``sb`` (kb,); a config from the menus with ``unroll_j`` dividing
    ``block_j`` and ``n_y_blocks`` 1 with ``use_column``.  More column
    blocks than j tiles are cut to the tiles, as the reference cuts
    them."""
    ts = (("a", a), ("b", b), ("sa", sa), ("sb", sb))
    for name, t in ts:
        if not t.is_contiguous() or t.dtype != torch.float32:
            raise ValueError(f"expdist: {name} must be a contiguous f32 "
                             f"tensor")
        if t.device != a.device:
            raise ValueError(f"expdist: {name} is on {t.device}, a on "
                             f"{a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != 2 or b.shape[0] != 2 \
            or tuple(sa.shape) != (a.shape[1],) \
            or tuple(sb.shape) != (b.shape[1],) \
            or a.shape[1] < 1 or b.shape[1] < 1:
        raise ValueError(f"expdist: shapes {[tuple(t.shape) for _, t in ts]}"
                         f" are not (2, ka), (2, kb), (ka,), (kb,)")
    bj = cfg["block_j"]
    if cfg["block_i"] not in kernel.BLOCK_I or bj not in kernel.BLOCK_J \
            or cfg["unroll_j"] not in kernel.UNROLL_J \
            or bj % cfg["unroll_j"] \
            or cfg["n_y_blocks"] not in kernel.N_Y_BLOCKS \
            or cfg["use_column"] not in (0, 1) \
            or (cfg["use_column"] and cfg["n_y_blocks"] != 1) \
            or cfg["exp_variant"] not in ("exp", "exp2") \
            or cfg["compute_dtype"] not in ("f32", "bf16"):
        raise ValueError(
            f"expdist: config {cfg} is outside the menus ("
            f"{kernel.BLOCK_I} x {kernel.BLOCK_J}, unroll_j dividing "
            f"block_j, n_y_blocks 1 with use_column)")


def expdist(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor,
            sb: torch.Tensor, config: dict | None = None) -> torch.Tensor:
    """The Gaussian-overlap distance of ``a`` (2, ka) with uncertainties
    ``sa`` (ka,) and ``b`` (2, kb) with ``sb`` (kb,): a scalar f32, under
    ``config`` (completed from :data:`DEFAULT_CONFIG`; with none, the one
    it resolves at this kb).  CUDA tensors run
    the kernel, or raise; CPU tensors run :func:`kernel.expdist_plain`."""
    if config:
        cfg = dict(DEFAULT_CONFIG, **config)
    else:
        from .space import build_space  # space.py imports this module
        if b.dim() != 2 or b.shape[1] < 1:
            raise ValueError(f"expdist: b {tuple(b.shape)} is not (2, kb)")
        cfg = resolve_config("expdist", build_space, {"kb": b.shape[1]},
                             DEFAULT_CONFIG, SEMANTIC, a.device)
    check(a, b, sa, sb, cfg)
    if a.device.type == "cpu":
        return kernel.expdist_plain(a, b, sa, sb, **cfg)
    if a.device.type != "cuda":
        raise ValueError(f"expdist: no kernel for device {a.device}")
    if torch.cuda.get_device_capability(a.device) != HOPPER:
        raise ValueError(f"expdist: the kernel is built for sm_90a; "
                         f"{torch.cuda.get_device_name(a.device)} is not")
    out = torch.empty((), dtype=torch.float32, device=a.device)
    kernel.launch(a, b, sa, sb, out, cfg)
    expdist.launches += 1
    expdist.device_launches += 2
    return out


expdist.launches = 0
expdist.device_launches = 0
