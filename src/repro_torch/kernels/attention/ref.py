"""Torch oracle for (G)QA attention: the JAX package's ``mha_reference``."""

from __future__ import annotations

import torch

#: the finite mask value of the JAX package (its kernel's ``NEG_INF``)
NEG_INF = -1e30


def mha_reference(q, k, v, *, causal=True, scale=None):
    """``q``: (Hq, Tq, D); ``k``/``v``: (Hkv, Tk, D); Hq % Hkv == 0.

    The default scale is computed as the jnp oracle computes it,
    ``1 / sqrt(d)`` in q's dtype (for bf16 at d = 128 that is 0.08837890625,
    not 128 ** -0.5).  The causal mask aligns to the bottom right (offset
    ``tk - tq``).  On a card this runs with TF32 off (PyTorch's default for
    matrix products), so the products are full f32.
    """
    hq, tq, d = q.shape
    hkv, tk, _ = k.shape
    g = hq // hkv
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(float(d))).to(q.dtype)
    kk = k.float().repeat_interleave(g, dim=0)
    vv = v.float().repeat_interleave(g, dim=0)
    logits = torch.einsum("hqd,hkd->hqk", q.float(), kk) * scale
    if causal:
        rows = torch.arange(tq, device=q.device)[:, None]
        cols = torch.arange(tk, device=q.device)[None, :]
        logits = torch.where(rows >= cols - (tk - tq), logits,
                             torch.tensor(NEG_INF, device=q.device))
    w = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True)
    return torch.einsum("hqk,hkd->hqd", w, vv).to(q.dtype)
