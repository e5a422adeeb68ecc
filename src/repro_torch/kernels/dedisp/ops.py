"""Public dedispersion op: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors, a count of kernel launches (``dedisp.launches``, one
a call) and one of the CUDA kernels the calls issue
(``dedisp.device_launches``, also one a call).  With no config a call runs
the default where the space admits it at the call's shape, else the nearest
admitted config with the default's acc_dtype
(:func:`~repro_torch.kernels.common.resolve_config`: the ring's slots grow
with T - t_out)."""

from __future__ import annotations

import torch

from ...device import HOPPER
from ..common import SMEM_PER_BLOCK, resolve_config
from . import kernel

#: the fastest config of the ``dedisp_h100`` space measured whole at the
#: default shape on an H100 80GB HBM3 at 700 W (``chip_smoke.py``, PERF.md
#: section 6): 8 DMs a block in 2 rows of 256 threads, 4 DMs x 16 samples
#: each, 2 channels a step, all of t_out a block
DEFAULT_CONFIG = {"block_d": 8, "block_c": 2, "time_chunk": 0,
                  "unroll_d": 4, "acc_dtype": "f32"}
#: the parameters that change the numerics, which a resolved config keeps
SEMANTIC = ("acc_dtype",)


def check(x: torch.Tensor, delays: torch.Tensor, t_out: int,
          cfg: dict) -> None:
    """Raise ValueError unless the operands and config fit the kernel: ``x``
    (C, T) f32 and ``delays`` (C, D) int32, contiguous, on one device, 1 <=
    ``t_out`` <= T, and a config from the menus with ``unroll_d`` dividing
    ``block_d``, at most 16 rows of DMs a block, and its shared memory
    within the card's at this shape.  The delays are the caller's to keep
    within [0, T - t_out]: the kernel clamps them to it, and so reads
    nothing outside x."""
    if x.dim() != 2 or not x.is_contiguous() or x.dtype != torch.float32:
        raise ValueError("dedisp: x must be a contiguous (C, T) f32 tensor")
    if delays.dim() != 2 or not delays.is_contiguous() \
            or delays.dtype != torch.int32 or delays.shape[0] != x.shape[0]:
        raise ValueError(f"dedisp: delays must be a contiguous (C, D) int32 "
                         f"tensor with C = {x.shape[0]}")
    if delays.device != x.device:
        raise ValueError(f"dedisp: delays are on {delays.device}, x on "
                         f"{x.device}")
    if not 1 <= t_out <= x.shape[1]:
        raise ValueError(f"dedisp: t_out {t_out} must be in 1..{x.shape[1]}")
    bd, ud = cfg["block_d"], cfg["unroll_d"]
    if bd not in kernel.BLOCK_D or cfg["block_c"] not in kernel.BLOCK_C \
            or cfg["time_chunk"] not in kernel.TIME_CHUNK \
            or ud not in kernel.UNROLL_D or bd % ud \
            or bd // ud > kernel.MAX_THREADS // kernel.MIN_ROW \
            or cfg["acc_dtype"] not in ("f32", "bf16"):
        raise ValueError(
            f"dedisp: config {cfg} is outside the menus (unroll_d must "
            f"divide block_d, and block_d / unroll_d be at most "
            f"{kernel.MAX_THREADS // kernel.MIN_ROW})")
    if kernel.config_stages(cfg, x.shape[0], t_out, x.shape[1]) < 2:
        raise ValueError(
            f"dedisp: config {cfg} leaves no room for a ring of two steps "
            f"in {SMEM_PER_BLOCK} B of shared memory at C = {x.shape[0]}, "
            f"t_out = {t_out} of T = {x.shape[1]}")


def dedisp(x: torch.Tensor, delays: torch.Tensor, t_out: int,
           config: dict | None = None) -> torch.Tensor:
    """The dedispersed series (D, t_out) f32 of ``x`` (C, T) under the
    delays (C, D), under ``config`` (completed from
    :data:`DEFAULT_CONFIG`; with none, the one it resolves at this shape).
    CUDA tensors run the kernel, or raise; CPU tensors run
    :func:`kernel.dedisp_plain`."""
    if config:
        cfg = dict(DEFAULT_CONFIG, **config)
    else:
        from .space import build_space  # space.py imports this module
        if x.dim() != 2 or delays.dim() != 2:
            raise ValueError("dedisp: x must be (C, T) and delays (C, D)")
        shape = {"d": delays.shape[1], "t_out": t_out, "t_in": x.shape[1],
                 "c": x.shape[0]}
        cfg = resolve_config("dedisp", build_space, shape, DEFAULT_CONFIG,
                             SEMANTIC, x.device)
    check(x, delays, t_out, cfg)
    if x.device.type == "cpu":
        return kernel.dedisp_plain(x, delays, t_out, **cfg)
    if x.device.type != "cuda":
        raise ValueError(f"dedisp: no kernel for device {x.device}")
    if torch.cuda.get_device_capability(x.device) != HOPPER:
        raise ValueError(f"dedisp: the kernel is built for sm_90a; "
                         f"{torch.cuda.get_device_name(x.device)} is not")
    out = torch.empty((delays.shape[1], t_out), dtype=torch.float32,
                      device=x.device)
    kernel.launch(x, delays, out, cfg)
    dedisp.launches += 1
    dedisp.device_launches += 1
    return out


dedisp.launches = 0
dedisp.device_launches = 0
