"""Torch oracle for the ExpDist Gaussian-overlap registration cost: the JAX
package's ``expdist_reference``.

    D = sum_{i,j} exp( -||a_i - b_j||^2 / (2*(sa_i^2 + sb_j^2)) )
"""

from __future__ import annotations

import torch

#: points a_i per step of the oracle: one step's (chunk, kb) terms stay
#: within about 270 MB at the reference's 65 536 points
CHUNK = 1024


def expdist_reference(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor,
                      sb: torch.Tensor) -> torch.Tensor:
    """``a``, ``b``: (2, K); ``sa``, ``sb``: (K,).  Returns a scalar in
    ``a``'s dtype (pass f64 tensors for an f64 oracle): the jnp oracle's
    math, one chunk of points a_i at a time (the (ka, kb) terms would take
    17 GB at the reference's shape), the chunks' sums added in order."""
    total = torch.zeros((), dtype=a.dtype, device=a.device)
    for s in range(0, a.shape[1], CHUNK):
        dx = a[0, s:s + CHUNK, None] - b[0][None, :]
        dy = a[1, s:s + CHUNK, None] - b[1][None, :]
        r2 = dx * dx + dy * dy
        denom = 2.0 * (sa[s:s + CHUNK, None] ** 2 + sb[None, :] ** 2)
        total = total + torch.exp(-r2 / denom).sum()
    return total
