"""Public GEMM op: the Hopper kernel for CUDA tensors, the plain version for
CPU tensors, and a count of kernel launches (``gemm.launches``)."""

from __future__ import annotations

import torch

from ...device import HOPPER
from . import kernel

#: the fastest config with B stored (K, N) that GA + random search found in
#: the ``gemm_h100`` space at 4096^3 on an H100 (``chip_smoke.py``, see
#: PERF.md).  With B stored (N, K) the same tile runs faster ("nk").
DEFAULT_CONFIG = {
    "block_m": 128, "block_n": 128, "block_k": 64, "unroll_k": 1,
    "warps": 4, "grid_order": "mn", "split_k": 1, "acc_dtype": "f32",
    "rhs_layout": "kn",
}


def check(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
          cfg: dict) -> None:
    """Raise ValueError unless the operands and config fit the kernel: 2-D,
    contiguous, on one device, ``b`` laid out per ``rhs_layout``, and every
    block dividing its dimension."""
    for name, t in (("a", a), ("b", b), ("c", c)):
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"gemm: {name} must be a contiguous 2-D tensor")
        if t.device != a.device:
            raise ValueError(f"gemm: {name} is on {t.device}, a on {a.device}")
    m, k = a.shape
    n = c.shape[1]
    want_b = (k, n) if cfg["rhs_layout"] == "kn" else (n, k)
    if c.shape[0] != m or tuple(b.shape) != want_b:
        raise ValueError(f"gemm: shapes a{tuple(a.shape)} b{tuple(b.shape)} "
                         f"c{tuple(c.shape)} do not fit rhs_layout="
                         f"{cfg['rhs_layout']!r} (b must be {want_b})")
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
    :data:`DEFAULT_CONFIG`).  ``b`` is (K, N) for ``rhs_layout="kn"`` and
    (N, K) for ``"nk"``.  CUDA tensors run the kernel, or raise; CPU
    tensors run :func:`kernel.gemm_plain`."""
    cfg = dict(DEFAULT_CONFIG)
    if config:
        cfg.update(config)
    check(a, b, c, cfg)
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
    if sk == 1:
        return out
    return kernel.combine_split(out, c, float(beta))


gemm.launches = 0
