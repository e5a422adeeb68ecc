"""Mixture-of-Experts FFN: grouped GShard-style top-k capacity dispatch.

The port of ``repro.models.moe``.  Tokens are processed in groups (the
classic trick that keeps the dispatch one-hots at O(tokens · k ·
capacity_factor) instead of O(tokens · E · C)); a token past an expert's
capacity in its group is dropped.  Optional shared experts (DeepSeek-style)
run densely on every token.  The JAX package's expert sharding is a no-op
on one device and is left out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Params

GROUP_SIZE = 128


def make_moe(d_model, d_ff_expert, n_experts, *, n_shared=0,
             d_ff_shared=None) -> Params:
    s = d_model ** -0.5
    p = Params()
    p.add("router", (d_model, n_experts), s, torch.float32)
    p.add("wi", (n_experts, d_model, d_ff_expert), s)
    p.add("wg", (n_experts, d_model, d_ff_expert), s)
    p.add("wo", (n_experts, d_ff_expert, d_model), d_ff_expert ** -0.5)
    if n_shared:
        dfs = d_ff_shared or n_shared * d_ff_expert
        p.add("shared_wi", (d_model, dfs), s)
        p.add("shared_wg", (d_model, dfs), s)
        p.add("shared_wo", (dfs, d_model), dfs ** -0.5)
    return p


def moe_ffn(p, x, *, top_k, capacity_factor=1.25, group_size=GROUP_SIZE,
            opt=False):
    """``x``: (B, T, D) -> (B, T, D) plus aux losses dict.  ``opt``
    (divisibility-aware dispatch sharding) changes nothing on one
    device."""
    b, t, d = x.shape
    e = p["router"].shape[1]
    n = b * t
    gs = min(group_size, n)
    g = n // gs
    xg = x.reshape(g, gs, d)

    logits = torch.einsum("gsd,de->gse", xg.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, top_k, dim=-1)       # (g, gs, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)

    cap = max(1, int(gs * top_k * capacity_factor / e))
    slots = torch.arange(cap, device=x.device)

    # GShard position bookkeeping: sequential over the k choices
    dispatch = torch.zeros((g, gs, e, cap), dtype=x.dtype, device=x.device)
    combine = torch.zeros((g, gs, e, cap), dtype=torch.float32,
                          device=x.device)
    fill = torch.zeros((g, e), dtype=torch.int64, device=x.device)
    for ki in range(top_k):
        mask = F.one_hot(idx[..., ki], e)                   # (g,gs,e)
        pos = torch.cumsum(mask, dim=1) - 1 + fill[:, None, :]
        keep = (pos < cap) & (mask > 0)
        pos_oh = (torch.where(keep, pos, -1)[..., None]
                  == slots).to(x.dtype)                     # (g,gs,e,cap)
        sel = mask.to(x.dtype)[..., None] * pos_oh
        dispatch = dispatch + sel
        combine = combine + sel.float() \
            * gate_vals[..., ki][..., None, None]
        fill = fill + mask.sum(dim=1)

    xe = torch.einsum("gsec,gsd->gecd", dispatch, xg)
    h = torch.einsum("gecd,edf->gecf", xe, p["wi"])
    gt = torch.einsum("gecd,edf->gecf", xe, p["wg"])
    h = F.silu(gt.float()).to(x.dtype) * h
    ye = torch.einsum("gecf,efd->gecd", h, p["wo"])
    y = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), ye)

    if "shared_wi" in p:
        hs = torch.einsum("gsd,df->gsf", xg, p["shared_wi"])
        gsh = torch.einsum("gsd,df->gsf", xg, p["shared_wg"])
        hs = F.silu(gsh.float()).to(x.dtype) * hs
        y = y + torch.einsum("gsf,fd->gsd", hs, p["shared_wo"])

    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(dim=(0, 1))                             # (e,)
    ce = F.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
    aux = e * torch.sum(me * ce)
    return y.reshape(b, t, d), {"aux_loss": aux}
