"""Public Hotspot op: the Hopper kernel for CUDA tensors, the plain version
for CPU tensors, a count of kernel launches (``hotspot.launches``, one a
call) and one of the CUDA kernels the calls issue
(``hotspot.device_launches``: ceil(n / tt) a call, all issued from C)."""

from __future__ import annotations

import torch

from ...device import HOPPER
from . import kernel

#: the fastest config measured at the default shape on an H100 80GB HBM3 at
#: 700 W (``chip_smoke.py``, PERF.md section 6): 10 sweeps a launch over
#: 64 x 128 tiles (5 columns a lane, 11 warps), power read through L1;
#: holding power in registers took 5 % longer there
DEFAULT_CONFIG = {"tt": 10, "block_h": 64, "block_w": 128, "unroll_t": 1,
                  "acc_dtype": "f32", "power_smem": 0, "grid_order": "rm"}


def check(temp: torch.Tensor, power: torch.Tensor, n_sweeps: int,
          cfg: dict) -> None:
    """Raise ValueError unless the operands and config fit the kernel: two
    contiguous 2-D f32 tensors of one shape on one device, ``n_sweeps`` >=
    0, and a config from the menus whose tile with its halo fits the
    register budget (``kernel.fits``)."""
    for name, t in (("temp", temp), ("power", power)):
        if t.dim() != 2 or not t.is_contiguous() or t.dtype != torch.float32:
            raise ValueError(f"hotspot: {name} must be a contiguous 2-D f32 "
                             f"tensor")
    if power.shape != temp.shape or power.device != temp.device:
        raise ValueError(f"hotspot: power {tuple(power.shape)} on "
                         f"{power.device} must match temp "
                         f"{tuple(temp.shape)} on {temp.device}")
    if n_sweeps < 0:
        raise ValueError(f"hotspot: n_sweeps {n_sweeps} < 0")
    if temp.numel() >= 2 ** 31:
        raise ValueError(f"hotspot: {tuple(temp.shape)} has 2^31 cells or "
                         f"more; the kernel indexes them with 32-bit ints")
    bh, bw, tt = cfg["block_h"], cfg["block_w"], cfg["tt"]
    if bh not in kernel.BLOCK_H or bw not in kernel.BLOCK_W \
            or tt not in kernel.TT or cfg["unroll_t"] not in kernel.UNROLL_T \
            or cfg["acc_dtype"] not in ("f32", "bf16") \
            or cfg["power_smem"] not in (0, 1) \
            or cfg["grid_order"] not in ("rm", "cm") \
            or not kernel.fits(bh, bw, tt) \
            or not kernel.compiled(bw, tt, cfg["unroll_t"]):
        raise ValueError(
            f"hotspot: config {cfg} is outside the menus, or its tile with "
            f"its halo does not fit the register budget")


def hotspot(temp: torch.Tensor, power: torch.Tensor, n_sweeps: int,
            config: dict | None = None) -> torch.Tensor:
    """``temp`` (H, W) advanced ``n_sweeps`` sweeps under ``power`` (H, W),
    (H, W) f32, under ``config`` (completed from :data:`DEFAULT_CONFIG`).
    CUDA tensors run the kernel, or raise; CPU tensors run
    :func:`kernel.hotspot_plain`."""
    cfg = dict(DEFAULT_CONFIG)
    if config:
        cfg.update(config)
    check(temp, power, n_sweeps, cfg)
    if temp.device.type == "cpu":
        return kernel.hotspot_plain(temp, power, n_sweeps, **cfg)
    if temp.device.type != "cuda":
        raise ValueError(f"hotspot: no kernel for device {temp.device}")
    if torch.cuda.get_device_capability(temp.device) != HOPPER:
        raise ValueError(f"hotspot: the kernel is built for sm_90a; "
                         f"{torch.cuda.get_device_name(temp.device)} is not")
    out = torch.empty_like(temp)
    scratch = torch.empty_like(temp)
    kernel.launch(temp, power, out, scratch, n_sweeps, cfg)
    hotspot.launches += 1
    hotspot.device_launches += -(-n_sweeps // cfg["tt"])
    return out


hotspot.launches = 0
hotspot.device_launches = 0
