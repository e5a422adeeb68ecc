"""Torch oracle for radio-astronomy dedispersion: the JAX package's
``dedisp_reference``, and the delay table its inputs use.

    out[d, t] = sum_c  x[c, t + delay[c, d]]        t in [0, T_out)

``delay`` is an int32 table from the cold-plasma dispersion law:
    delay(c, d) = round( k_dm * DM(d) * (1/f_c^2 - 1/f_hi^2) / t_samp )
"""

from __future__ import annotations

import numpy as np
import torch

#: DMs per step of the oracle: one step's (C, chunk, t_out) samples stay
#: within about 400 MB at the reference's shape
CHUNK = 16


def make_delays(n_chan: int, n_dm: int, *, f_lo=1.2e9, f_hi=1.7e9,
                dm_step=1.0, t_samp=4.1e-5, k_dm=4.148808e15) -> np.ndarray:
    """(n_chan, n_dm) int32 delay table in samples (channel 0 = highest
    frequency), in f32 operation for operation as the JAX package's
    ``make_delays`` computes it.  The frequencies follow ``jnp.linspace``'s
    formula, ``f_hi * (1 - s) + f_lo * s`` with ``s = i / (n - 1)`` in f32,
    the second product fused into the sum (computed in f64, then rounded).
    XLA's rounding of that formula depends on how it vectorises it on the
    host, so no numpy expression reproduces it everywhere: at the
    reference's shape 241 of its 1536 frequencies differ in the last bit,
    and 771 of the 3 145 728 delays, clipped as the problem clips them, by
    one sample (ROADMAP queue 3)."""
    f32 = np.float32
    s = np.arange(n_chan).astype(f32) / f32(max(n_chan - 1, 1))
    freqs = ((f32(f_hi) * (f32(1.0) - s)).astype(np.float64)
             + np.float64(f32(f_lo)) * s).astype(f32)
    dms = np.arange(n_dm).astype(f32) * f32(dm_step)
    inv = f32(1.0) / (freqs * freqs)
    delays = (f32(k_dm) * dms[None, :]) * (inv[:, None] - f32(1.0 / f_hi ** 2))
    return np.rint(delays / f32(t_samp)).astype(np.int32)


def dedisp_reference(x: torch.Tensor, delays: torch.Tensor,
                     t_out: int) -> torch.Tensor:
    """``x``: (C, T); ``delays``: (C, D) int.  Returns (D, t_out) f32: the
    jnp oracle's gather and sum over channels, a chunk of DMs at a time."""
    ar = torch.arange(t_out, device=x.device)
    out = []
    for s in range(0, delays.shape[1], CHUNK):
        idx = delays[:, s:s + CHUNK, None].long() + ar            # (C, d, t)
        rows = torch.gather(x[:, None, :].expand(-1, idx.shape[1], -1), 2,
                            idx)
        out.append(rows.float().sum(dim=0))
    return torch.cat(out, dim=0)
