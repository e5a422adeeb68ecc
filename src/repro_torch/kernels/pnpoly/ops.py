"""Public point-in-polygon op: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors, a count of kernel launches (``pnpoly.launches``,
one a call) and one of the CUDA kernels the calls issue
(``pnpoly.device_launches``, also one a call).  With no config from the
caller it runs :data:`DEFAULT_CONFIG` where that fits the shape, else the
nearest config the space admits there
(:func:`~repro_torch.kernels.common.resolve_config`: an ``unroll_v`` no
larger than V, which always exists)."""

from __future__ import annotations

import torch

from ...device import HOPPER
from ..common import resolve_config
from . import kernel

#: measured over the whole ``pnpoly_h100`` space at the default shape on an
#: H100 (see PERF.md): the fastest config with the points as (2, N) rows,
#: the layout callers hold.  The same config with float2 points was 0.2 %
#: faster, within the card's noise.
DEFAULT_CONFIG = {"block_points": 4096, "unroll_v": 8, "between_method": 0,
                  "use_method": 2, "precompute_slope": 1,
                  "coord_layout": "soa"}
#: what a resolved config keeps of the default: its methods and layout
SEMANTIC = ("between_method", "use_method", "coord_layout")


def check_operands(points: torch.Tensor, poly: torch.Tensor,
                   coord_layout: str) -> None:
    """Raise ValueError unless the operands fit the op: f32, contiguous, on
    one device, ``points`` laid out per ``coord_layout`` ((2, N) or (N,
    2)) and ``poly`` (2, V) with 1 <= V <= 4096."""
    for name, t in (("points", points), ("poly", poly)):
        if t.dim() != 2 or not t.is_contiguous() or t.dtype != torch.float32:
            raise ValueError(f"pnpoly: {name} must be a contiguous 2-D f32 "
                             f"tensor")
    if poly.device != points.device:
        raise ValueError(f"pnpoly: poly is on {poly.device}, points on "
                         f"{points.device}")
    aos = coord_layout == "aos"
    if (points.shape[1] if aos else points.shape[0]) != 2 \
            or poly.shape[0] != 2 or not 1 <= poly.shape[1] <= kernel.MAX_V:
        raise ValueError(f"pnpoly: shapes points{tuple(points.shape)} "
                         f"poly{tuple(poly.shape)} do not fit coord_layout="
                         f"{coord_layout!r} and (2, V), V <= "
                         f"{kernel.MAX_V}")


def check(points: torch.Tensor, poly: torch.Tensor, cfg: dict) -> None:
    """Raise ValueError unless the operands and config fit the kernel: the
    operands as :func:`check_operands` says, and every value within the
    compiled menus."""
    check_operands(points, poly, cfg["coord_layout"])
    if cfg["block_points"] not in kernel.BLOCK_POINTS \
            or cfg["unroll_v"] not in kernel.UNROLL_V \
            or cfg["between_method"] not in kernel.BETWEEN_METHODS \
            or cfg["use_method"] not in kernel.USE_METHODS \
            or cfg["precompute_slope"] not in (0, 1) \
            or cfg["coord_layout"] not in ("soa", "aos"):
        raise ValueError(f"pnpoly: config {cfg} is outside the compiled "
                         f"menus")


def pnpoly(points: torch.Tensor, poly: torch.Tensor,
           config: dict | None = None) -> torch.Tensor:
    """Inside flags, int32 (N,), of ``points`` ((2, N) for ``coord_layout``
    "soa", (N, 2) for "aos") against the polygon ``poly`` (2, V), under
    ``config`` (completed from :data:`DEFAULT_CONFIG`; with none, the one
    it resolves at this shape).  CUDA tensors run
    the kernel, or raise; CPU tensors run :func:`kernel.pnpoly_plain`."""
    if config:
        cfg = dict(DEFAULT_CONFIG, **config)
        check(points, poly, cfg)
    else:
        from .space import build_space  # space.py imports this module
        check_operands(points, poly, DEFAULT_CONFIG["coord_layout"])
        cfg = resolve_config(
            "pnpoly", build_space, {"n": points.shape[1], "v": poly.shape[1]},
            DEFAULT_CONFIG, SEMANTIC, points.device)
    if points.device.type == "cpu":
        return kernel.pnpoly_plain(points, poly, **cfg)
    if points.device.type != "cuda":
        raise ValueError(f"pnpoly: no kernel for device {points.device}")
    if torch.cuda.get_device_capability(points.device) != HOPPER:
        raise ValueError(f"pnpoly: the kernel is built for sm_90a; "
                         f"{torch.cuda.get_device_name(points.device)} is not")
    n = points.shape[0] if cfg["coord_layout"] == "aos" else points.shape[1]
    out = torch.empty(n, dtype=torch.int32, device=points.device)
    kernel.launch(points, poly, out, cfg)
    pnpoly.launches += 1
    pnpoly.device_launches += 1
    return out


pnpoly.launches = 0
pnpoly.device_launches = 0
