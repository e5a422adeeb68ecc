"""Mixture-of-Experts FFN: grouped GShard-style top-k capacity dispatch.

The port of ``repro.models.moe``.  Tokens are processed in groups (the
classic trick that keeps the dispatch one-hots at O(tokens · k ·
capacity_factor) instead of O(tokens · E · C)); a token past an expert's
capacity in its group is dropped.  Optional shared experts (DeepSeek-style)
run densely on every token.  Experts are sharded over the ``model`` mesh
axis ("expert" logical axis) under a mesh, through the JAX package's
constraints (:func:`repro_torch.distributed.sharding.constrain`, the
argument itself without one).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..distributed.sharding import axis_size, constrain, local_region
from .layers import Params, einsum

GROUP_SIZE = 128


def make_moe(d_model, d_ff_expert, n_experts, *, n_shared=0,
             d_ff_shared=None) -> Params:
    s = d_model ** -0.5
    p = Params()
    p.add("router", (d_model, n_experts), s, torch.float32,
          ("embed", "expert"))
    p.add("wi", (n_experts, d_model, d_ff_expert), s,
          axes=("expert", "embed", "ff"))
    p.add("wg", (n_experts, d_model, d_ff_expert), s,
          axes=("expert", "embed", "ff"))
    p.add("wo", (n_experts, d_ff_expert, d_model), d_ff_expert ** -0.5,
          axes=("expert", "ff", "embed"))
    if n_shared:
        dfs = d_ff_shared or n_shared * d_ff_expert
        p.add("shared_wi", (d_model, dfs), s, axes=("embed", "ff"))
        p.add("shared_wg", (d_model, dfs), s, axes=("embed", "ff"))
        p.add("shared_wo", (dfs, d_model), dfs ** -0.5, axes=("ff", "embed"))
    return p


def _experts(xe, combine, wi, wg, wo):
    """The experts' SwiGLU on the dispatched ``xe`` (g, e, cap, d) and the
    weighted combine back to (g, s, d).  DTensors go through
    :func:`_experts_sharded`."""
    if isinstance(xe, DTensor):
        return _experts_sharded(xe, combine, wi, wg, wo)
    h = einsum("gecd,edf->gecf", xe, wi)
    gt = einsum("gecd,edf->gecf", xe, wg)
    h = F.silu(gt.float()).to(xe.dtype) * h
    ye = einsum("gecf,efd->gecd", h, wo)
    return einsum("gsec,gecd->gsd", combine, ye)


def _experts_sharded(xe, combine, wi, wg, wo):
    """:func:`_experts` on each rank's local shards, by the placements the
    constraint gave ``xe``: on a mesh dim that shards the groups the
    weights are gathered; on one that shards the experts (EP) the weights
    and the combine weights are cut to the local experts; on any other
    the weights keep an ff sharding (TP-style experts) or are gathered.
    The result is sharded over the groups as ``xe``, and summed over the
    EP and TP mesh dims."""
    w_in, w_out, x_pl, c_pl, y_pl = [], [], [], [], []
    for px, pw in zip(xe.placements, wi.placements):
        rep = Replicate()
        if px == Shard(0):                       # groups: gather weights
            w_in.append(rep), w_out.append(rep)
            x_pl.append(px), c_pl.append(px), y_pl.append(px)
        elif px == Shard(1):                     # experts (EP)
            w_in.append(Shard(0)), w_out.append(Shard(0))
            x_pl.append(px), c_pl.append(Shard(2)), y_pl.append(Partial())
        elif pw == Shard(2):                     # ff (TP-style experts)
            w_in.append(Shard(2)), w_out.append(Shard(1))
            x_pl.append(rep), c_pl.append(rep), y_pl.append(Partial())
        else:
            w_in.append(rep), w_out.append(rep)
            x_pl.append(rep), c_pl.append(rep), y_pl.append(rep)
    return local_region(_experts, [(xe, x_pl), (combine, c_pl), (wi, w_in),
                                   (wg, w_in), (wo, w_out)], y_pl,
                      (xe.shape[0], combine.shape[1], xe.shape[3]))


def moe_ffn(p, x, *, top_k, capacity_factor=1.25, group_size=GROUP_SIZE,
            opt=False):
    """``x``: (B, T, D) -> (B, T, D) plus aux losses dict.

    ``opt`` (opt_moe): divisibility-aware dispatch sharding.  The baseline
    pins the expert axis of the dispatched activations to ``model``
    unconditionally; with ``opt`` the expert axis is only model-sharded
    when divisible (EP); otherwise experts run TP-style — the ff axis of
    the expert weights is model-sharded and dispatch stays data-local."""
    b, t, d = x.shape
    e = p["router"].shape[1]
    n = b * t
    gs = min(group_size, n)
    g = n // gs
    xg = constrain(x.reshape(g, gs, d), ("pod", "data"), None, None)

    logits = einsum("gsd,de->gse", xg.float(), p["router"])
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

    # dispatch -> (g, e, cap, d): the all-to-all boundary (g:data, e:model)
    xe = einsum("gsec,gsd->gecd", dispatch, xg)
    if opt and axis_size("model") > 1 and e % axis_size("model"):
        # TP-style experts: no EP all-to-all, ff stays sharded in weights
        xe = constrain(xe, ("pod", "data"), None, None, None)
    else:
        xe = constrain(xe, ("pod", "data"), "model", None, None)
    y = _experts(xe, combine.to(x.dtype), p["wi"], p["wg"], p["wo"])

    if "shared_wi" in p:
        hs = einsum("gsd,df->gsf", xg, p["shared_wi"])
        gsh = einsum("gsd,df->gsf", xg, p["shared_wg"])
        hs = F.silu(gsh.float()).to(x.dtype) * hs
        y = y + einsum("gsf,fd->gsd", hs, p["shared_wo"])

    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(dim=(0, 1))                             # (e,)
    ce = F.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
    aux = e * torch.sum(me * ce)
    return y.reshape(b, t, d), {"aux_loss": aux}
