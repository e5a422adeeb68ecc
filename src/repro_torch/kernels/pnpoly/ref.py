"""Torch oracle for point in polygon: the JAX package's ``pnpoly_reference``
(the crossing number, even-odd rule)."""

from __future__ import annotations

import torch

#: points per step of the oracle: the (V, chunk) comparisons of one step
#: stay within a few hundred MB at the reference's 600 vertices
CHUNK = 1 << 16


def pnpoly_reference(points: torch.Tensor, poly: torch.Tensor) -> torch.Tensor:
    """``points``: (2, N); ``poly``: (2, V) vertices in order.  Returns
    int32 (N,): 1 if inside.  The crossing is computed as the jnp oracle
    computes it, ``(x2 - x1) * (py - y1) / den + x1``, one chunk of points
    at a time."""
    x1, y1 = poly[0][:, None], poly[1][:, None]            # (V, 1)
    x2, y2 = torch.roll(x1, -1, 0), torch.roll(y1, -1, 0)
    den = y2 - y1
    safe = torch.where(den == 0, torch.ones_like(den), den)
    out = []
    for s in range(0, points.shape[1], CHUNK):
        px = points[0, s:s + CHUNK][None, :]
        py = points[1, s:s + CHUNK][None, :]
        between = (y1 > py) != (y2 > py)
        xint = (x2 - x1) * (py - y1) / safe + x1
        crossings = between & (px < xint)
        out.append(crossings.sum(dim=0) % 2)
    return torch.cat(out).to(torch.int32)
