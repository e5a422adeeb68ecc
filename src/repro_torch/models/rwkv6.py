"""RWKV-6 "Finch" block: attention-free linear recurrence with
data-dependent per-channel decay and token shift.

The port of ``repro.models.rwkv6``.  State per head: S ∈ R^{dk × dv}.  Per
token:
    S_t = diag(w_t) · S_{t-1} + k_t^T (v_t)
    o_t = (r_t · S_t) ... with bonus term u ⊙ (r_t·k_t) v_t
Projections (r,k,v,w,g) are batched over the full sequence outside the scan;
the scan carries only the (B,H,dk,dv) f32 state, a loop over the tokens of
each chunk of at most :data:`SCAN_CHUNK` (the JAX package's chunks, where
it bounds the backward pass's memory).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..distributed.sharding import as_dtensor, local_region, shard_span
from .layers import Params, _plan, einsum, rms_norm, scan_chunks

HEAD_DIM = 64
SCAN_CHUNK = 256


def make_rwkv6(d_model) -> Params:
    h = d_model // HEAD_DIM
    s = d_model ** -0.5
    p = Params()
    flat = ("embed", "heads_flat")
    for name in ("wr", "wk", "wv"):
        p.add(name, (d_model, d_model), s, axes=flat)
    p.add("ww", (d_model, d_model), s * 0.1, axes=flat)
    p.add("wg", (d_model, d_model), s, axes=flat)
    p.add("wo", (d_model, d_model), s, axes=("heads_flat", "embed"))
    p.add("w_bias", (d_model,), 0.5, torch.float32, ("heads_flat",))
    p.add("u", (h, HEAD_DIM), 0.3, torch.float32, ("heads", "head_dim"))
    p.add("shift_mix", (5, d_model), 0.2, torch.float32, (None, "embed"))
    p.add("ln_out", (d_model,), "ones", torch.float32, ("embed",))
    return p


PROJ = ("wr", "wk", "wv", "ww", "wg")


def _projections(p, x, x_prev):
    """Token-shifted projections.  ``x``: (B,T,D); ``x_prev``: (B,T,D) is x
    shifted right by one (data-dependent mixing simplified to learned mix).
    DTensors through :func:`_projections_sharded`."""
    if any(isinstance(t, DTensor) for t in (x, x_prev, p["wr"])):
        outs = _projections_sharded(p, x, x_prev)
    else:
        outs = []
        for i, w in enumerate(PROJ):
            mix = torch.sigmoid(p["shift_mix"][i]).to(x.dtype)
            xi = x * mix + x_prev * (1.0 - mix)
            outs.append(einsum("btd,de->bte", xi, p[w]))
    r, k, v, w_raw, g = outs
    # data-dependent decay in log space: log w_t = -exp(raw) (≤ 0 always)
    logw = -torch.exp(torch.clamp(w_raw.float() + p["w_bias"], -8.0, 4.0))
    return r, k, v, logw, g


def _projections_sharded(p, x, x_prev):
    """:func:`_projections` on each rank's local shards, in one local region
    that ``x``, ``x_prev`` and the mixes enter once: the five products are
    placed by :func:`~.layers._plan` (their weights share one spec, so one
    placement of ``x``), the mixes are cut to the model dims ``x`` holds,
    and the backward reduces ``x``'s and ``x_prev``'s gradients once each,
    where five products of five mixed inputs would reduce five."""
    ws = [p[w] for w in PROJ]
    mesh = next(t.device_mesh for t in (x, x_prev, *ws)
                if isinstance(t, DTensor))
    x, x_prev = as_dtensor(x, mesh), as_dtensor(x_prev, mesh)
    plans = [_plan("btd,de->bte", x, as_dtensor(w, mesh)) for w in ws]
    xw = plans[0][1]
    mw = [Shard(1) if q == Shard(2) else Replicate() for q in xw]

    def fn(lx, lxp, lm, *lws):
        outs = []
        for i, lw in enumerate(lws):
            mix = torch.sigmoid(lm[i]).to(lx.dtype)
            xi = lx * mix + lxp * (1.0 - mix)
            outs.append(torch.einsum(plans[i][0], xi, lw))
        return outs

    return local_region(
        fn, [(x, xw), (x_prev, xw), (p["shift_mix"], mw)]
        + [(w, plan[2]) for w, plan in zip(ws, plans)],
        [plan[3] for plan in plans], [plan[4] for plan in plans])


def _split_heads(x, h):
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h)


def _output(p, out, g, x):
    out = rms_norm(out.to(x.dtype), p["ln_out"])
    out = out * F.silu(g.float()).to(x.dtype)
    return einsum("btd,de->bte", out, p["wo"])


def _wkv_chunk(s, r, k, v, logw, u):
    """The recurrence over one chunk's tokens: the state after it and the
    (B,t,H,dv) outputs."""
    outs = []
    for i in range(r.shape[1]):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]     # (B,H,dk,dv)
        outs.append(einsum("bhk,bhkv->bhv", r[:, i], s + u * kv))
        s = torch.exp(logw[:, i])[..., None] * s + kv
    return s, torch.stack(outs, dim=1)


def _wkv(s, r, k, v, logw, u):
    """The recurrence over all (B,T,H,d) tokens, chunk by chunk: the last
    state and the (B,T,H,dv) outputs.  DTensors go through
    :func:`_wkv_sharded`."""
    if isinstance(r, DTensor):
        return _wkv_sharded(s, r, k, v, logw, u)
    return scan_chunks(_wkv_chunk, s, (r, k, v, logw), (u,), SCAN_CHUNK)


def _wkv_sharded(s, r, k, v, logw, u):
    """:func:`_wkv` on each rank's local shards: the recurrence is
    independent across batch and heads, so a mesh dim on which r, k, v
    and logw all shard batch (dim 0) or all shard heads (dim 2) stays so
    (``u``, (1,H,dk,1), and the state cut to match), and the inputs are
    replicated on any other."""
    ins = (r, k, v, logw)
    want, u_pl, s_pl = [], [], []
    for ps in zip(*(a.placements for a in ins)):
        keep = len(set(ps)) == 1 and ps[0] in (Shard(0), Shard(2))
        want.append(ps[0] if keep else Replicate())
        u_pl.append(Shard(1) if keep and ps[0] == Shard(2) else Replicate())
        s_pl.append(Shard(1) if keep and ps[0] == Shard(2) else want[-1])
    b, t, h = r.shape[:3]
    return tuple(local_region(
        lambda ls, lu, *local: _wkv(ls, *local, lu),
        [(s, s_pl), (u, u_pl), *((a, want) for a in ins)],
        [s_pl, want], [(b, h, *s.shape[2:]), (b, t, h, v.shape[3])]))


def _split(r):
    """Whether the heads split evenly over every mesh dim that shards the
    channels of DTensor ``r`` (B,T,D) (a plain tensor: yes)."""
    if not isinstance(r, DTensor):
        return True
    n = 1
    for size, pl in zip(r.device_mesh.shape, r.placements):
        if pl == Shard(2):
            n *= size
    return (r.shape[2] // HEAD_DIM) % n == 0


def _mix_gathered(s, r, k, v, logw, u):
    """:func:`_wkv` of (B,T,D) DTensors whose channels a mesh dim cuts
    inside a head (the model axis wider than the heads), in one local
    region: r, k, v and logw enter with whole heads (each gathered over
    the mesh dims that shard its channels, as its batch shard stays), the
    recurrence runs on them, and each rank keeps its channels of the
    output, the placement of the inputs that ``wo``'s product takes (the
    gradients reduce-scattered back to the inputs' shards on the way
    back).  r, k and v come in f32, the dtype the recurrence takes them
    in, so their gradients' partial sums are reduced before one rounding
    to bf16, as on one device.  The state leaves whole over those
    dims."""
    b, t, d = r.shape
    h = d // HEAD_DIM
    ins = (r, k, v, logw)
    want = [pl if pl == Shard(0) else Replicate() for pl in r.placements]
    out = [Shard(2) if pl == Shard(2) else w
           for pl, w in zip(r.placements, want)]
    lo, n = shard_span(d, r.device_mesh, out, 2)

    def fn(ls, lu, lr, lk, lv, lw):
        s, o = _wkv(ls, *(_split_heads(a, h) for a in (lr, lk, lv, lw)), lu)
        return [s, o.reshape(*o.shape[:2], d)[..., lo:lo + n]]

    return tuple(local_region(
        fn, [(s, want), (u, [Replicate()] * len(want))]
        + [(a, want) for a in ins],
        [want, out], [(b, h, *s.shape[2:]), (b, t, d)]))


def _mix(p, x, x_prev, s):
    """The time mix of (B,T,D) ``x`` after ``x_prev`` (x shifted right by
    one token) from state ``s``: its output and the last state.  Where a
    mesh dim cuts a head, the recurrence runs in :func:`_mix_gathered`."""
    b, t, d = x.shape
    h = d // HEAD_DIM
    r, k, v, logw, g = _projections(p, x, x_prev)
    u = p["u"][None, :, :, None]
    if _split(r):
        r, k, v = (_split_heads(a, h).float() for a in (r, k, v))
        s, out = _wkv(s, r, k, v, _split_heads(logw, h), u)
        out = out.reshape(b, t, d)                           # (B,T,H*dv)
    else:
        s, out = _mix_gathered(s, r.float(), k.float(), v.float(), logw, u)
    return _output(p, out, g, x), s


def rwkv6_forward(p, x, *, state=None, make_cache=False):
    """Full-sequence pass, chunk by chunk."""
    b, t, d = x.shape
    x_prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    s = state if state is not None else \
        torch.zeros((b, d // HEAD_DIM, HEAD_DIM, HEAD_DIM),
                    dtype=torch.float32, device=x.device)
    out, s = _mix(p, x, x_prev, s)
    # decode state = (S, last token) — the token-shift mix needs x_{t-1}
    return out, ((s, x[:, -1, :]) if make_cache else None)


def rwkv6_decode(p, x, state_tuple, *, position=None):
    """One-token step: the forward's recurrence (a chunk of one token)
    from ``state_tuple`` = (S, x_prev_token), a DTensor's on its local
    shards as in the forward (:func:`_wkv_sharded`, or
    :func:`_mix_gathered` where a mesh dim cuts a head)."""
    s, xprev = state_tuple
    out, s_new = _mix(p, x, xprev[:, None, :], s)
    return out, (s_new, x[:, 0, :])
