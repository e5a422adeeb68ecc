"""Public attention op: the Hopper kernel for CUDA tensors, the plain version
for CPU tensors, and a count of kernel launches (``attention.launches``)."""

from __future__ import annotations

import torch

from ...device import HOPPER
from . import kernel

#: measured on an H100 over the whole ``flash_attention_h100`` space at the
#: default shape (``chip_smoke.py``, see PERF.md): the fastest config with
#: an f32 accumulator and ``block_h`` 1, so that it fits every GQA group.
#: The fastest overall shares each K/V tile among 4 heads (``block_h`` 4).
DEFAULT_CONFIG = {"block_q": 64, "block_kv": 64, "block_h": 1,
                  "skip_masked": 1, "acc_dtype": "f32"}


def check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          cfg: dict) -> None:
    """Raise ValueError unless the operands and config fit the kernel: 3-D,
    contiguous, on one device, q (Hq, Tq, D) and k, v (Hkv, Tk, D) with Hkv
    dividing Hq, ``block_h`` dividing the group Hq // Hkv, every block
    dividing its dimension, and a block of whole warps within the menu."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"attention: {name} must be a contiguous 3-D "
                             f"tensor")
        if t.device != q.device:
            raise ValueError(f"attention: {name} is on {t.device}, q on "
                             f"{q.device}")
    hq, tq, d = q.shape
    hkv, tk, dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or dk != d or hkv < 1 or hq % hkv:
        raise ValueError(f"attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} do not fit "
                         f"(Hq, Tq, D) and (Hkv, Tk, D) with Hkv | Hq")
    bq, bkv, bh = cfg["block_q"], cfg["block_kv"], cfg["block_h"]
    if (hq // hkv) % bh or tq % bq or tk % bkv or bq % kernel.ROWS_PER_WARP \
            or bkv not in kernel.BLOCK_KV \
            or kernel.warps(bq, bh) not in kernel.WARPS:
        raise ValueError(
            f"attention: config {cfg} does not fit Hq={hq}, Hkv={hkv}, "
            f"Tq={tq}, Tk={tk} (block_h must divide the group, blocks their "
            f"dimensions, block_h * block_q / 16 be one of {kernel.WARPS} "
            f"warps, block_kv one of {kernel.BLOCK_KV})")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: float | None = None,
              config: dict | None = None) -> torch.Tensor:
    """Attention of ``q`` (Hq, Tq, D) over ``k``, ``v`` (Hkv, Tk, D) under
    ``config`` (completed from :data:`DEFAULT_CONFIG`); ``scale`` defaults
    to ``D ** -0.5``.  CUDA tensors run the kernel, or raise; CPU tensors
    run :func:`kernel.flash_attention_plain`."""
    cfg = dict(DEFAULT_CONFIG)
    if config:
        cfg.update(config)
    check(q, k, v, cfg)
    d = q.shape[2]
    scale = float(d) ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return kernel.flash_attention_plain(q, k, v, causal=causal,
                                            scale=scale, **cfg)
    if q.device.type != "cuda":
        raise ValueError(f"attention: no kernel for device {q.device}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError("attention: the kernel takes bf16 q, k and v")
    if d not in kernel.HEAD_DIMS:
        raise ValueError(f"attention: the kernel is built for head dims "
                         f"{kernel.HEAD_DIMS}, not {d}")
    if torch.cuda.get_device_capability(q.device) != HOPPER:
        raise ValueError(f"attention: the kernel is built for sm_90a; "
                         f"{torch.cuda.get_device_name(q.device)} is not")
    out = torch.empty_like(q)
    kernel.launch(q, k, v, out, cfg, causal, scale)
    attention.launches += 1
    return out


attention.launches = 0
