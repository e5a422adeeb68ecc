"""Mixture-of-Experts FFN: grouped GShard-style top-k capacity dispatch.

The port of ``repro.models.moe``.  Tokens are processed in groups (the
classic trick that keeps the dispatch one-hots at O(tokens · k ·
capacity_factor) instead of O(tokens · E · C)); a token past an expert's
capacity in its group is dropped.  Optional shared experts (DeepSeek-style)
run densely on every token.  Experts are sharded over the ``model`` mesh
axis ("expert" logical axis) under a mesh, where the whole layer runs in
one local region (:func:`_moe_sharded`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..distributed.sharding import (all_reduce, as_dtensor, constrain,
                                    local_region, shard_span)
from .layers import Params, einsum, einsum_shared

GROUP_SIZE = 128
#: the layer's weights, the shared experts' last (absent without them)
WEIGHTS = ("router", "wi", "wg", "wo", "shared_wi", "shared_wg", "shared_wo")


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
    weighted combine back to (g, s, d)."""
    h = einsum("gecd,edf->gecf", xe, wi)
    gt = einsum("gecd,edf->gecf", xe, wg)
    h = F.silu(gt.float()).to(xe.dtype) * h
    ye = einsum("gecf,efd->gecd", h, wo)
    return einsum("gsec,gecd->gsd", combine, ye)


def _shared(xg, wi, wg, wo):
    """The shared experts' SwiGLU on every token of ``xg`` (g, s, d)."""
    hs, gsh = einsum_shared(xg, ("gsd,df->gsf", wi), ("gsd,df->gsf", wg))
    hs = F.silu(gsh.float()).to(xg.dtype) * hs
    return einsum("gsf,fd->gsd", hs, wo)


def _gates(logits, top_k):
    """The router's softmax over the experts of ``logits`` (g, gs, e), and
    its normalised top-k gate values and expert ids."""
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, idx


def _dispatch(gate_vals, idx, e, cap, dtype):
    """GShard position bookkeeping, sequential over the k choices: the
    (g, gs, e, cap) one-hot dispatch (in ``dtype``) and the f32 combine
    weights; a token past an expert's capacity in its group is dropped."""
    g, gs, top_k = idx.shape
    slots = torch.arange(cap, device=idx.device)
    dispatch = torch.zeros((g, gs, e, cap), dtype=dtype, device=idx.device)
    combine = torch.zeros((g, gs, e, cap), dtype=torch.float32,
                          device=idx.device)
    fill = torch.zeros((g, e), dtype=torch.int64, device=idx.device)
    for ki in range(top_k):
        mask = F.one_hot(idx[..., ki], e)                   # (g,gs,e)
        pos = torch.cumsum(mask, dim=1) - 1 + fill[:, None, :]
        keep = (pos < cap) & (mask > 0)
        pos_oh = (torch.where(keep, pos, -1)[..., None]
                  == slots).to(dtype)                       # (g,gs,e,cap)
        sel = mask.to(dtype)[..., None] * pos_oh
        dispatch = dispatch + sel
        combine = combine + sel.float() \
            * gate_vals[..., ki][..., None, None]
        fill = fill + mask.sum(dim=1)
    return dispatch, combine


def _capacity(gs, top_k, capacity_factor, e) -> int:
    return max(1, int(gs * top_k * capacity_factor / e))


def _scaled(t, w: float):
    """``t`` times ``w`` (1 or 0: a rank's share of a pending sum)."""
    return t if w == 1.0 else t * w


def moe_ffn(p, x, *, top_k, capacity_factor=1.25, group_size=GROUP_SIZE):
    """``x``: (B, T, D) -> (B, T, D) plus aux losses dict; under a mesh,
    :func:`_moe_sharded`."""
    b, t, d = x.shape
    e = p["router"].shape[1]
    n = b * t
    gs = min(group_size, n)
    g = n // gs
    xg = constrain(x.reshape(g, gs, d), ("pod", "data"), None, None)
    if any(isinstance(t, DTensor) for t in
           (xg, *(p[k] for k in WEIGHTS if k in p))):
        y, aux = _moe_sharded(p, xg, top_k, capacity_factor)
        return y.reshape(b, t, d), {"aux_loss": aux}

    logits = einsum("gsd,de->gse", xg.float(), p["router"])
    probs, gate_vals, idx = _gates(logits, top_k)           # (g, gs, k)
    me = probs.mean(dim=(0, 1))                             # (e,)
    ce = F.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
    aux = e * torch.sum(me * ce)                            # Switch-style

    cap = _capacity(gs, top_k, capacity_factor, e)
    dispatch, combine = _dispatch(gate_vals, idx, e, cap, x.dtype)
    xe = einsum("gsec,gsd->gecd", dispatch, xg)
    y = _experts(xe, combine.to(x.dtype), p["wi"], p["wg"], p["wo"])
    if "shared_wi" in p:
        y = y + _shared(xg, p["shared_wi"], p["shared_wg"], p["shared_wo"])
    return y.reshape(b, t, d), {"aux_loss": aux}


def _moe_sharded(p, xg, top_k, capacity_factor):
    """:func:`moe_ffn` of DTensor ``xg`` (g, gs, d) in one local region,
    which ``xg`` enters once: the router's product, the routing, the
    dispatch and combine bookkeeping, the experts and the shared experts
    all run on each rank's local shards, so the backward sums their local
    gradients of ``xg`` before it reduces them, one all-reduce a layer.

    Mesh dim by mesh dim, by the placements the constraint gave ``xg`` and
    the specs gave the weights: where ``xg`` shards the groups, everything
    stays local to them and the weights are gathered; on any other mesh
    dim ``xg`` is whole, and the experts run on the experts that dim's
    shard of the weights holds (EP: the dispatch and the combine weights
    cut to them) or on an ff shard of every expert (TP-style), or are
    gathered, and the shared experts on their ff shard or gathered.  The
    router is gathered whole, so every rank routes its tokens over all the
    experts.  The result is a pending sum on each mesh dim that splits the
    experts or the shared experts (a part that dim does not split is
    added on its first rank alone, so the sum counts it once), reduced on
    the way out.  The load-balance loss needs the mean probabilities and
    first choices over all the groups: their (2, e) sums are all-reduced
    inside the region (a part that a mesh dim does not split again
    counted on its first rank alone), every rank computes the loss on
    them, and it leaves as a pending sum held by the first rank of each
    mesh dim that reduced them.  Nothing follows the region's own ops but
    its reductions on the way out, so a recompute (remat) that stops once
    the saved tensors are back never repeats them."""
    ws = {k: p[k] for k in WEIGHTS if k in p}
    mesh = next(t.device_mesh for t in (xg, *ws.values())
                if isinstance(t, DTensor))
    xg = as_dtensor(xg, mesh)
    ws = {k: as_dtensor(w, mesh) for k, w in ws.items()}
    g, gs, d = xg.shape
    e = ws["router"].shape[1]
    shared = "shared_wi" in ws
    rep = Replicate()
    xw, e_in, e_out, s_in, s_out, yw, sw = [], [], [], [], [], [], []
    split_e, split_s = [], []             # per mesh dim: experts, shared
    for px, pe, ps in zip(xg.placements, ws["wi"].placements,
                          ws["shared_wi"].placements if shared
                          else ws["wi"].placements):
        groups = px == Shard(0)
        xw.append(px if groups else rep)
        ep = not groups and pe == Shard(0)
        ff = not groups and pe == Shard(2)
        sff = shared and not groups and ps == Shard(1)
        e_in.append(Shard(0) if ep else Shard(2) if ff else rep)
        e_out.append(Shard(0) if ep else Shard(1) if ff else rep)
        s_in.append(Shard(1) if sff else rep)
        s_out.append(Shard(0) if sff else rep)
        split_e.append(ep or ff)
        split_s.append(sff)
        yw.append(px if groups else Partial() if ep or ff or sff else rep)
        sw.append(Partial() if groups or ep or ff or sff else rep)
    lo, n_e = shard_span(e, mesh, e_in, 0)
    coord = mesh.get_coordinate()
    lead = [i for i, p in enumerate(yw) if p == Partial()]
    red = [i for i, p in enumerate(sw) if p == Partial()]

    def first(dims, split=None):
        """1 where this rank is the first of each of ``dims`` that
        ``split`` (a flag a mesh dim) does not split, else 0."""
        return float(all(coord[i] == 0 for i in dims
                         if not (split and split[i])))

    cap = _capacity(gs, top_k, capacity_factor, e)
    one_e, one_s = first(lead, split_e), first(lead, split_s)
    one_sums, one_aux = first(lead), first(red)

    def fn(lx, lr, lwi, lwg, lwo, *lsh):
        logits = torch.einsum("gsd,de->gse", lx.float(), lr)
        probs, gate_vals, idx = _gates(logits, top_k)
        sums = torch.stack([probs.sum(dim=(0, 1)), F.one_hot(
            idx[..., 0], e).to(probs.dtype).sum(dim=(0, 1))])
        sums = all_reduce(_scaled(sums, one_sums), mesh, red)
        me, ce = (sums / (g * gs)).unbind(0)
        aux = e * torch.sum(me * ce)
        dispatch, combine = _dispatch(gate_vals, idx, e, cap, lx.dtype)
        dispatch = dispatch[:, :, lo:lo + n_e]
        combine = combine[:, :, lo:lo + n_e]
        xe = torch.einsum("gsec,gsd->gecd", dispatch, lx)
        y = _scaled(_experts(xe, combine.to(lx.dtype), lwi, lwg, lwo), one_e)
        if lsh:
            y = y + _scaled(_shared(lx, *lsh), one_s)
        return [_scaled(aux, one_aux), y]

    ins = [(xg, xw), (ws["router"], [rep] * len(xw)), (ws["wi"], e_in),
           (ws["wg"], e_in), (ws["wo"], e_out)]
    if shared:
        ins += [(ws["shared_wi"], s_in), (ws["shared_wg"], s_in),
                (ws["shared_wo"], s_out)]
    aux, y = local_region(fn, ins, [sw, yw], [(), (g, gs, d)])
    return y, aux
