"""Public 2-D convolution op: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors, a count of kernel launches (``conv2d.launches``,
one a call) and one of the CUDA kernels the calls issue
(``conv2d.device_launches``: two where a bf16 filter is first packed for
constant memory, else one).  With no config from the caller it runs
:data:`DEFAULT_CONFIG` where that fits the shape, else the nearest config
the space admits there (:func:`~repro_torch.kernels.common.resolve_config`);
where none fits (an output narrower than the smallest block), the CPU runs
the plain version with the default and a CUDA tensor raises."""

from __future__ import annotations

import torch

from ...device import HOPPER
from ..common import resolve_config
from . import kernel

#: the fastest config of the whole ``conv2d_h100`` space at the default
#: shape, as ``chip_smoke.py``'s conv2d landscape measured it on an NVIDIA
#: H100 80GB HBM3 at 700 W (PERF.md section 6 names the run): 32 x 32
#: outputs a block, 2 x 4 a thread, the whole filter unrolled and in
#: constant memory, f32.  At another filter size the unroll factors snap to
#: its divisors.
DEFAULT_CONFIG = {"block_h": 32, "block_w": 32, "unroll_fh": 15,
                  "unroll_fw": 15, "row_chunk": 2, "col_chunk": 4,
                  "acc_dtype": "f32", "filter_smem": 0}
#: what a resolved config keeps of the default: its accumulator
SEMANTIC = ("acc_dtype",)


def check_operands(image: torch.Tensor, filt: torch.Tensor) -> None:
    """Raise ValueError unless the operands fit the op: 2-D f32,
    contiguous, on one device, and a square filter no larger than the
    image."""
    for name, t in (("image", image), ("filt", filt)):
        if t.dim() != 2 or not t.is_contiguous() or t.dtype != torch.float32:
            raise ValueError(f"conv2d: {name} must be a contiguous 2-D f32 "
                             f"tensor")
    if filt.device != image.device:
        raise ValueError(f"conv2d: filt is on {filt.device}, image on "
                         f"{image.device}")
    fh, fw = filt.shape
    if fh != fw or fh > min(image.shape):
        raise ValueError(f"conv2d: filter {tuple(filt.shape)} must be square "
                         f"and fit the image {tuple(image.shape)}")


def check(image: torch.Tensor, filt: torch.Tensor, cfg: dict) -> None:
    """Raise ValueError unless the operands and config fit the kernel: the
    operands as :func:`check_operands` says, and a compiled tile
    (``row_chunk`` x ``col_chunk``, dividing ``block_h`` and ``block_w``)
    in a block of 128 threads to the tile's ``kernel.max_threads``, from the
    compiled menus, at least ``kernel.ROW_THREADS`` of them along a
    row."""
    check_operands(image, filt)
    bh, bw = cfg["block_h"], cfg["block_w"]
    rc, cc = cfg["row_chunk"], cfg["col_chunk"]
    if bh not in kernel.BLOCK_H or bw not in kernel.BLOCK_W \
            or (rc, cc) not in kernel.TILES or bh % rc or bw % cc \
            or cfg["acc_dtype"] not in ("f32", "bf16") \
            or not kernel.MIN_THREADS <= kernel.threads(bh, bw, rc, cc) \
            <= kernel.max_threads(rc, cc, cfg["acc_dtype"]) \
            or bw // cc < kernel.ROW_THREADS \
            or cfg["unroll_fh"] not in kernel.UNROLL \
            or cfg["unroll_fw"] not in kernel.UNROLL \
            or cfg["filter_smem"] not in (0, 1):
        raise ValueError(
            f"conv2d: config {cfg} is outside the compiled menus (a compiled "
            f"row_chunk x col_chunk tile dividing the block, "
            f"{kernel.MIN_THREADS} threads to the tile's launch bound, at "
            f"least {kernel.ROW_THREADS} a row)")


def conv2d(image: torch.Tensor, filt: torch.Tensor,
           config: dict | None = None) -> torch.Tensor:
    """The 'valid' correlation of ``image`` (H, W) with ``filt`` (F, F),
    (H - F + 1, W - F + 1) f32, under ``config`` (completed from
    :data:`DEFAULT_CONFIG`, whose unroll factors snap to divisors of F;
    with none, the one it resolves at this shape).
    CUDA tensors run the kernel, or raise; CPU tensors run
    :func:`kernel.conv2d_plain`."""
    if config:
        cfg = dict(DEFAULT_CONFIG, **config)
        check(image, filt, cfg)
    else:
        from .space import build_space  # space.py imports this module
        check_operands(image, filt)
        (h, w), (fh, fw) = image.shape, filt.shape
        cfg = resolve_config(
            "conv2d", build_space, {"h": h, "w": w, "fh": fh, "fw": fw},
            DEFAULT_CONFIG, SEMANTIC, image.device)
    if image.device.type == "cpu":
        return kernel.conv2d_plain(image, filt, **cfg)
    if image.device.type != "cuda":
        raise ValueError(f"conv2d: no kernel for device {image.device}")
    f = filt.shape[0]
    if f not in kernel.FILTER_SIZES:
        raise ValueError(f"conv2d: the kernel is built for filters of "
                         f"{kernel.FILTER_SIZES}, not {f}")
    if torch.cuda.get_device_capability(image.device) != HOPPER:
        raise ValueError(f"conv2d: the kernel is built for sm_90a; "
                         f"{torch.cuda.get_device_name(image.device)} is not")
    out = torch.empty((image.shape[0] - f + 1, image.shape[1] - f + 1),
                      dtype=torch.float32, device=image.device)
    kernel.launch(image, filt, out, cfg)
    conv2d.launches += 1
    conv2d.device_launches += 1 + int(cfg["acc_dtype"] == "bf16"
                                      and not cfg["filter_smem"])
    return out


conv2d.launches = 0
conv2d.device_launches = 0
