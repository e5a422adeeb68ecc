"""Torch oracle for the single-channel 'valid' 2-D convolution (a
correlation, as in the paper): the JAX package's ``conv2d_reference``.

    O(y, x) = sum_{i,j} I(y+i, x+j) * F(i, j)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_reference(image: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """``image`` (H, W), ``filt`` (FH, FW) -> (H - FH + 1, W - FW + 1) in
    ``image``'s dtype, computed in f32.  On a card cuDNN would run an f32
    convolution in TF32 by default; TF32 is off here, so the products are
    full f32 as the jnp oracle's."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = F.conv2d(image.float()[None, None], filt.float()[None, None])
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return out[0, 0].to(image.dtype)
