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

from ..distributed.sharding import local_region
from .layers import Params, einsum, rms_norm

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


def _projections(p, x, x_prev):
    """Token-shifted projections.  ``x``: (B,T,D); ``x_prev``: (B,T,D) is x
    shifted right by one (data-dependent mixing simplified to learned mix)."""
    outs = []
    for i, w in enumerate(("wr", "wk", "wv", "ww", "wg")):
        mix = torch.sigmoid(p["shift_mix"][i]).to(x.dtype)
        xi = x * mix + x_prev * (1.0 - mix)
        outs.append(einsum("btd,de->bte", xi, p[w]))
    r, k, v, w_raw, g = outs
    # data-dependent decay in log space: log w_t = -exp(raw) (≤ 0 always)
    logw = -torch.exp(torch.clamp(w_raw.float() + p["w_bias"], -8.0, 4.0))
    return r, k, v, logw, g


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
    t = r.shape[1]
    chunk = min(SCAN_CHUNK, t)
    while t % chunk:
        chunk -= 1
    outs = []
    for c in range(0, t, chunk):
        s, o = _wkv_chunk(s, *(a[:, c:c + chunk] for a in (r, k, v, logw)),
                          u)
        outs.append(o)
    return s, torch.cat(outs, dim=1)


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


def rwkv6_forward(p, x, *, state=None, make_cache=False):
    """Full-sequence pass, chunk by chunk."""
    b, t, d = x.shape
    h = d // HEAD_DIM
    x_prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    r, k, v, logw, g = _projections(p, x, x_prev)
    r, k, v = (_split_heads(a, h).float() for a in (r, k, v))
    logw = _split_heads(logw, h)
    u = p["u"][None, :, :, None]

    s = state if state is not None else \
        torch.zeros((b, h, HEAD_DIM, HEAD_DIM), dtype=torch.float32,
                    device=x.device)
    s, out = _wkv(s, r, k, v, logw, u)
    out = out.reshape(b, t, d)                               # (B,T,H*dv)
    out = _output(p, out, g, x)
    # decode state = (S, last token) — the token-shift mix needs x_{t-1}
    return out, ((s, x[:, -1, :]) if make_cache else None)


def rwkv6_decode(p, x, state_tuple, *, position=None):
    """One-token step.  ``state_tuple`` = (S, x_prev_token)."""
    s, xprev = state_tuple
    b, _, d = x.shape
    h = d // HEAD_DIM
    r, k, v, logw, g = _projections(p, x, xprev[:, None, :])
    r, k, v = (_split_heads(a, h).float()[:, 0] for a in (r, k, v))
    lw = _split_heads(logw, h)[:, 0]
    kv = k[..., :, None] * v[..., None, :]
    out = einsum("bhk,bhkv->bhv", r, s + p["u"][None, :, :, None] * kv)
    s_new = torch.exp(lw)[..., None] * s + kv
    out = _output(p, out.reshape(b, 1, d), g, x)
    return out, (s_new, x[:, 0, :])
