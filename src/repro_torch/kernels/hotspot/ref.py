"""Torch oracle for the Hotspot thermal stencil: the JAX package's
``hotspot_reference``.

One sweep on the (already halo-padded) domain, edge-replicated boundary:

    t' = t + step * (p + Ry*(up + down - 2t) + Rx*(left + right - 2t)
                       + Rz*(amb - t))

Callers crop the halo afterwards (the reference compares the central crop).
"""

from __future__ import annotations

import torch

DEFAULTS = dict(step=0.5, rx=0.1, ry=0.1, rz=0.05, amb=80.0)


def neighbours(t: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The up, down, left and right neighbour of every cell, a cell on the
    domain's edge standing in for its missing neighbour."""
    up = torch.cat([t[:1], t[:-1]], 0)
    down = torch.cat([t[1:], t[-1:]], 0)
    left = torch.cat([t[:, :1], t[:, :-1]], 1)
    right = torch.cat([t[:, 1:], t[:, -1:]], 1)
    return up, down, left, right


def sweep(t: torch.Tensor, p: torch.Tensor, *, step, rx, ry, rz, amb):
    up, down, left, right = neighbours(t)
    return t + step * (p + ry * (up + down - 2 * t)
                       + rx * (left + right - 2 * t) + rz * (amb - t))


def hotspot_reference(temp: torch.Tensor, power: torch.Tensor,
                      n_sweeps: int, **consts) -> torch.Tensor:
    """``n_sweeps`` sweeps in f32 over the whole domain, in ``temp``'s
    dtype."""
    c = {**DEFAULTS, **consts}
    t, p = temp.float(), power.float()
    for _ in range(n_sweeps):
        t = sweep(t, p, **c)
    return t.to(temp.dtype)
