"""Public GEMM op: the Hopper kernel for CUDA tensors, the plain version for
CPU tensors, a count of kernel launches (``gemm.launches``, one a call) and
one of the CUDA kernels the calls issue (``gemm.device_launches``, also one
a call).  With no config from the caller it runs :data:`DEFAULT_CONFIG` where
that fits the shape, else the nearest config the space admits there
(:func:`~repro_torch.kernels.common.resolve_config`); where none fits, the
CPU runs the plain version with the default and a CUDA tensor raises."""

from __future__ import annotations

import torch

from ...device import HOPPER
from ..common import resolve_config
from . import kernel

#: the fastest config with B stored (K, N) that GA + random search found in
#: the ``gemm_h100`` space at 4096^3 on an H100 (``chip_smoke.py``, PERF.md
#: section 6): two consumer warpgroups splitting a 256-row tile, the
#: deepest ring that fits.  With B stored (N, K) the same tile is as fast.
DEFAULT_CONFIG = {
    "block_m": 256, "block_n": 128, "block_k": 64, "unroll_k": 1,
    "warps": 8, "stages": 4, "grid_order": "mn", "split_k": 1,
    "acc_dtype": "f32", "rhs_layout": "kn",
}
#: what a resolved config keeps of the default: its accumulator and layout
SEMANTIC = ("acc_dtype", "rhs_layout")


def check_operands(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   rhs_layout: str) -> None:
    """Raise ValueError unless the operands fit the op: 2-D, contiguous, on
    one device, and ``b`` laid out per ``rhs_layout``."""
    for name, t in (("a", a), ("b", b), ("c", c)):
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"gemm: {name} must be a contiguous 2-D tensor")
        if t.device != a.device:
            raise ValueError(f"gemm: {name} is on {t.device}, a on {a.device}")
    m, k = a.shape
    n = c.shape[1]
    want_b = (k, n) if rhs_layout == "kn" else (n, k)
    if c.shape[0] != m or tuple(b.shape) != want_b:
        raise ValueError(f"gemm: shapes a{tuple(a.shape)} b{tuple(b.shape)} "
                         f"c{tuple(c.shape)} do not fit rhs_layout="
                         f"{rhs_layout!r} (b must be {want_b})")


def check(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
          cfg: dict) -> None:
    """Raise ValueError unless the operands and config fit the kernel: the
    operands as :func:`check_operands` says, and every block dividing its
    dimension."""
    check_operands(a, b, c, cfg["rhs_layout"])
    m, k = a.shape
    n = c.shape[1]
    sk, bk = cfg["split_k"], cfg["block_k"]
    if (m % cfg["block_m"] or n % cfg["block_n"] or k % (sk * bk)):
        raise ValueError(
            f"gemm: ({m}, {n}, {k}) is not divisible by block_m="
            f"{cfg['block_m']}, block_n={cfg['block_n']}, "
            f"split_k*block_k={sk * bk}")


def gemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
         alpha: float = 1.0, beta: float = 1.0,
         config: dict | None = None) -> torch.Tensor:
    """``alpha * a @ b + beta * c`` under ``config`` (completed from
    :data:`DEFAULT_CONFIG`; with none, the one it resolves at this
    shape).  ``b`` is (K, N) for ``rhs_layout="kn"`` and
    (N, K) for ``"nk"``.  CUDA tensors run the kernel, or raise; CPU
    tensors run :func:`kernel.gemm_plain`."""
    if config:
        cfg = dict(DEFAULT_CONFIG, **config)
        check(a, b, c, cfg)
    else:
        from .space import build_space  # space.py imports this module
        check_operands(a, b, c, DEFAULT_CONFIG["rhs_layout"])
        cfg = resolve_config(
            "gemm", build_space,
            {"m": a.shape[0], "n": c.shape[1], "k": a.shape[1]},
            DEFAULT_CONFIG, SEMANTIC, a.device)
    if a.device.type == "cpu":
        return kernel.gemm_plain(a, b, c, alpha=alpha, beta=beta, **cfg)
    if a.device.type != "cuda":
        raise ValueError(f"gemm: no kernel for device {a.device}")
    if any(t.dtype != torch.bfloat16 for t in (a, b, c)):
        raise ValueError("gemm: the kernel takes bf16 a, b and c")
    if torch.cuda.get_device_capability(a.device) != HOPPER:
        raise ValueError(f"gemm: the kernel is built for sm_90a; "
                         f"{torch.cuda.get_device_name(a.device)} is not")
    m, n, sk = a.shape[0], c.shape[1], cfg["split_k"]
    out = torch.empty((sk, m, n) if sk > 1 else (m, n), dtype=c.dtype,
                      device=a.device)
    kernel.launch(a, b, c, out, cfg, float(alpha),
                  float(beta) if sk == 1 else 0.0)
    gemm.launches += 1
    gemm.device_launches += 1
    if sk == 1:
        return out
    return kernel.combine_split(out, c, float(beta))


gemm.launches = 0
gemm.device_launches = 0
