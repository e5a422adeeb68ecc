"""Torch oracle for softened all-pairs N-body accelerations: the JAX
package's ``nbody_reference``."""

from __future__ import annotations

import torch

G = 1.0
EPS2 = 1e-3
#: bodies i per step of the oracle: the (3, chunk, N) differences of one
#: step stay within about 400 MB at the reference's 131 072 bodies
CHUNK = 256


def nbody_reference(pos: torch.Tensor, mass: torch.Tensor,
                    eps2: float = EPS2) -> torch.Tensor:
    """``pos``: (3, N); ``mass``: (N,).  Returns accelerations (3, N), in
    ``pos``'s dtype (pass f64 tensors for an f64 oracle).  The jnp
    oracle's math, ``G * sum_j m_j d_ij / (r2 * sqrt(r2))`` with ``d_ij =
    x_j - x_i`` and ``r2 = |d_ij|^2 + eps2``, one chunk of bodies i at a
    time (the (3, N, N) differences would take 200 GB at N = 131 072)."""
    out = []
    for s in range(0, pos.shape[1], CHUNK):
        d = pos[:, None, :] - pos[:, s:s + CHUNK, None]    # (3, i, j)
        r2 = (d * d).sum(dim=0) + eps2                      # (i, j)
        inv3 = 1.0 / (r2 * torch.sqrt(r2))
        w = mass[None, :] * inv3
        out.append(G * (d * w[None]).sum(dim=2))            # (3, i)
    return torch.cat(out, dim=1)
