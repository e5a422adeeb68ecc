"""Attention blocks: GQA (optionally windowed / qk-norm / cross) and MLA.

The port of ``repro.models.attention``.  Two execution paths per block:
  * ``forward``       — full-sequence (training / prefill); returns new cache
  * ``decode``        — one token against a KV cache (serving)

Prefill attention runs the port's flash kernel
(:func:`repro_torch.kernels.attention.ops.attention`, the Hopper
counterpart of the Pallas kernel that the JAX package names as its
deployment path behind this interface) wherever the kernel takes the
call, as :func:`prefill_route` decides from the shapes and the grad state
before anything runs; everything else, training (which the kernel, having
no backward, never takes) and decode included, runs :func:`_sdpa`, the plain
formulation of the JAX package's jnp attention.  :data:`ROUTES` counts the
calls of :func:`gqa_forward` by route.  The JAX package's sharding
constraints are no-ops on one device and are left out.
"""

from __future__ import annotations

from collections import Counter

import torch

from ..kernels.attention import kernel as flash_kernel
from ..kernels.attention import ops as flash_ops
from ..kernels.attention.space import build_space as flash_space
from ..kernels.common import config_at
from .layers import Params, apply_rope, rms_norm

NEG_INF = -1e30

#: :func:`gqa_forward`'s attention calls by route: ``"kernel:plan"`` and
#: ``"kernel:resolved"`` count the flash kernel's launches (one a sequence)
#: under the caller's config and under the one the op resolves, ``"plain"``
#: the calls of :func:`_sdpa` (one a call)
ROUTES: Counter = Counter()
#: ``attention_impl`` values: ``"auto"`` takes the kernel where
#: :func:`prefill_route` says, ``"plain"`` never does
IMPLS = ("auto", "plain")


# --------------------------------------------------------------------- #
# GQA
# --------------------------------------------------------------------- #
def make_gqa(d_model, n_heads, n_kv, d_head, qk_norm=False) -> Params:
    s = d_model ** -0.5
    p = Params()
    p.add("wq", (d_model, n_heads, d_head), s)
    p.add("wk", (d_model, n_kv, d_head), s)
    p.add("wv", (d_model, n_kv, d_head), s)
    p.add("wo", (n_heads, d_head, d_model), (n_heads * d_head) ** -0.5)
    if qk_norm:
        p.add("q_norm", (d_head,), "ones", torch.float32)
        p.add("k_norm", (d_head,), "ones", torch.float32)
    return p


def _mask_bias(tq, tk, offset, window, causal=True, device=None):
    """(tq, tk) additive bias.  ``offset`` = absolute position of query 0
    minus absolute position of key 0.  ``window``: None/0 = unlimited."""
    rows = torch.arange(tq, device=device)[:, None] + offset
    cols = torch.arange(tk, device=device)[None, :]
    ok = (rows >= cols) if causal else \
        torch.ones((tq, tk), dtype=torch.bool, device=device)
    if window:
        ok = ok & (rows - cols < window)
    return torch.zeros((tq, tk), dtype=torch.float32,
                       device=device).masked_fill(~ok, NEG_INF)


def _sdpa(q, k, v, bias):
    """``q``/``k``: (B,T,H,Dh) with GQA head grouping; ``v`` may have a
    different value dim.  f32 logits and softmax, the weights cast to v's
    dtype for the product with v."""
    b, tq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    q = q.reshape(b, tq, hkv, g, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
    logits = logits * (dh ** -0.5) + bias
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
    return out.reshape(b, tq, h, v.shape[-1])


#: opt_attn q-chunking: cap live logits at (tq/chunks x tk) per chunk.
SDPA_Q_CHUNKS = 16


def _sdpa_chunked(q, k, v, *, window, causal):
    """Exact q-chunked attention (opt_attn, long sequences): each chunk's
    softmax sees the full key range, so only the live (tq_c x tk) logits
    block shrinks by the chunk count; the mask is built per chunk."""
    tq, tk = q.shape[1], k.shape[1]
    n = max(1, min(SDPA_Q_CHUNKS, tq // 512))
    while tq % n:
        n -= 1
    c = tq // n
    outs = []
    for i in range(n):
        bias = _mask_bias(c, tk, (tk - tq) + i * c, window, causal, q.device)
        outs.append(_sdpa(q[:, i * c:(i + 1) * c], k, v, bias))
    return torch.cat(outs, dim=1) if n > 1 else outs[0]


def prefill_route(q, k, *, window, causal, kv_override,
                  impl="auto", v=None) -> str:
    """``"kernel"`` where the flash kernel takes this attention, else
    ``"plain"``.  Where autograd would record through the attention
    (grad enabled and q, k or v requiring grad) it is always ``"plain"``:
    the kernel has no backward, as the JAX package's Pallas kernel has
    none and its training path runs the jnp attention.  Otherwise, under
    ``impl="auto"``, ``"kernel"`` for CUDA bf16 causal self-attention with
    Tq = Tk, no window, a head dim the kernel is built for, and a shape
    where some config of the ``flash_attention_h100`` space fits.
    Decided before anything runs; once it says ``"kernel"``, a failing
    launch raises."""
    if impl not in IMPLS:
        raise ValueError(f"attention_impl must be one of {IMPLS}, not "
                         f"{impl!r}")
    if torch.is_grad_enabled() and any(
            getattr(t, "requires_grad", False) for t in (q, k, v)):
        return "plain"
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if impl == "plain" or q.device.type != "cuda" \
            or q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 \
            or kv_override is not None or window or not causal \
            or tq != tk or d not in flash_kernel.HEAD_DIMS:
        return "plain"
    shape = {"hq": hq, "hkv": hkv, "tq": tq, "tk": tk, "d": d}
    if config_at(flash_space, shape, flash_ops.DEFAULT_CONFIG,
                 flash_ops.SEMANTIC) is None:
        return "plain"
    return "kernel"


def admitted_config(q, k, v, config: dict | None) -> dict | None:
    """``config`` where ``ops.check`` admits it for the (H,T,D) q, k and v
    (completed from the op's ``DEFAULT_CONFIG``), else None: the config to
    offer the flash kernel, which resolves its own when given none."""
    if not config:
        return None
    try:
        flash_ops.check(q, k, v, dict(flash_ops.DEFAULT_CONFIG, **config))
    except ValueError:
        return None
    return config


def _flash(q, k, v, config):
    """Causal attention of (B,T,H,D) q over (B,T,Hkv,D) k and v by the
    flash kernel, one launch a sequence, under ``config`` where the op
    admits it at this shape, else (and with none) the config the op
    resolves."""
    out = torch.empty_like(q)
    for i in range(q.shape[0]):
        qi, ki, vi = (t[i].transpose(0, 1).contiguous() for t in (q, k, v))
        if i == 0:
            cfg = admitted_config(qi, ki, vi, config)
        ROUTES["kernel:plan" if cfg else "kernel:resolved"] += 1
        out[i] = flash_ops.attention(qi, ki, vi, causal=True,
                                     config=cfg).transpose(0, 1)
    return out


def gqa_forward(p, x, *, positions, window=None, causal=True, qk_norm=False,
                rope_theta=10_000.0, kv_override=None, make_cache=True,
                opt=False, kv_repeat=1, impl="auto", kernel_config=None):
    """Full-sequence attention.  Returns (out, cache).

    ``kv_repeat`` (opt_attn): replicate kv heads r-fold so the effective kv
    count matches TP — the Megatron GQA deployment trick.
    ``repeat_interleave`` on axis 2 keeps group alignment (new kv head j
    serves q heads with h // g_eff == j, and j // r is the original head).
    ``impl`` and ``kernel_config``: the route (:func:`prefill_route`) and
    the config offered to the flash kernel."""
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    src = kv_override if kv_override is not None else x
    k = torch.einsum("btd,dhk->bthk", src, p["wk"])
    v = torch.einsum("btd,dhk->bthk", src, p["wv"])
    if qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if rope_theta:
        q = apply_rope(q, positions, rope_theta)
        kpos = positions if kv_override is None else \
            torch.arange(k.shape[1], device=k.device)[None]
        k = apply_rope(k, kpos, rope_theta)
    if kv_repeat > 1:
        k = torch.repeat_interleave(k, kv_repeat, dim=2)
        v = torch.repeat_interleave(v, kv_repeat, dim=2)
    if prefill_route(q, k, window=window, causal=causal,
                     kv_override=kv_override, impl=impl, v=v) == "kernel":
        out = _flash(q, k, v, kernel_config)
    else:
        ROUTES["plain"] += 1
        if opt and q.shape[1] >= 2048:
            out = _sdpa_chunked(q, k, v, window=window, causal=causal)
        else:
            bias = _mask_bias(q.shape[1], k.shape[1], 0, window, causal,
                              q.device)
            out = _sdpa(q, k, v, bias)
    out = torch.einsum("bthk,hkd->btd", out, p["wo"])
    cache = {"k": k, "v": v} if make_cache else None
    return out, cache


def _insert_row(cache, new, insert_b):
    """Write ``new`` (B,1,...) into per-batch row ``insert_b`` of ``cache``
    (B,T,...).  One-hot blend — vectorized over the batch so every slot may
    sit at a different sequence position (continuous batching)."""
    t = cache.shape[1]
    onehot = torch.arange(t, device=cache.device)[None, :] \
        == insert_b[:, None]                                   # (B,T)
    onehot = onehot.reshape(onehot.shape + (1,) * (cache.ndim - 2))
    return torch.where(onehot, new.to(cache.dtype), cache)


def _scatter_row(cache, new, insert_b):
    """The same write as :func:`_insert_row` by indexing: one row a batch
    entry, written into ``cache`` in place (``opt_scatter_cache``)."""
    cache[torch.arange(cache.shape[0], device=cache.device), insert_b] = \
        new[:, 0].to(cache.dtype)
    return cache


def _positions(position, b, device):
    """A scalar or (B,) position as a (B,) int64 tensor."""
    return torch.as_tensor(position, device=device).long().expand(b)


def gqa_decode(p, x, cache, *, position, insert_at=None, qk_norm=False,
               rope_theta=10_000.0, opt=False, kv_repeat=1, scatter=False):
    """One-token decode.  ``x``: (B,1,D); cache k/v: (B,Tc,Hkv_eff,Dh).

    ``position`` is the absolute token position (RoPE + validity mask) —
    a scalar (lockstep decode) or an (B,) array (per-slot positions,
    continuous batching).  ``insert_at`` is the cache slot (ring buffers
    pass position % window — keys carry absolute RoPE phases, so slot order
    is irrelevant).  Validity: slots <= position are live, which is exact
    both before the ring wraps (slots beyond position are empty) and after
    (all live).

    ``scatter`` (opt_scatter_cache): update the cache row in place by
    indexing instead of the one-hot blend, which reads and rewrites the
    whole cache every token.  ``kv_repeat``: the cache stores replicated
    kv heads (see gqa_forward).  ``opt`` changes nothing on one device.
    """
    b = x.shape[0]
    pos_b = _positions(position, b, x.device)
    ins_b = pos_b if insert_at is None else \
        _positions(insert_at, b, x.device)
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    k_new = torch.einsum("btd,dhk->bthk", x, p["wk"])
    v_new = torch.einsum("btd,dhk->bthk", x, p["wv"])
    if qk_norm:
        q = rms_norm(q, p["q_norm"])
        k_new = rms_norm(k_new, p["k_norm"])
    if rope_theta:
        q = apply_rope(q, pos_b[:, None], rope_theta)
        k_new = apply_rope(k_new, pos_b[:, None], rope_theta)
    if kv_repeat > 1:
        k_new = torch.repeat_interleave(k_new, kv_repeat, dim=2)
        v_new = torch.repeat_interleave(v_new, kv_repeat, dim=2)
    write = _scatter_row if scatter else _insert_row
    k = write(cache["k"], k_new, ins_b)
    v = write(cache["v"], v_new, ins_b)
    tk = k.shape[1]
    cols = torch.arange(tk, device=x.device)[None, :]
    bias = torch.zeros((b, tk), dtype=torch.float32, device=x.device) \
        .masked_fill(cols > pos_b[:, None], NEG_INF)
    bias = bias[:, None, None, None, :]          # (B,1,1,1,Tk) per-slot
    out = _sdpa(q, k, v, bias)
    out = torch.einsum("bthk,hkd->btd", out, p["wo"])
    return out, {"k": k, "v": v}


# --------------------------------------------------------------------- #
# MLA (DeepSeek-V2 multi-head latent attention)
# --------------------------------------------------------------------- #
def make_mla(d_model, n_heads, *, kv_lora=512, q_lora=1536, nope_dim=128,
             rope_dim=64, v_dim=None) -> Params:
    v_dim = v_dim if v_dim is not None else nope_dim
    s = d_model ** -0.5
    p = Params()
    p.add("w_dq", (d_model, q_lora), s)
    p.add("w_uq", (q_lora, n_heads, nope_dim + rope_dim), q_lora ** -0.5)
    p.add("w_dkv", (d_model, kv_lora), s)
    p.add("w_kpe", (d_model, rope_dim), s)
    p.add("w_uk", (kv_lora, n_heads, nope_dim), kv_lora ** -0.5)
    p.add("w_uv", (kv_lora, n_heads, v_dim), kv_lora ** -0.5)
    p.add("wo", (n_heads, v_dim, d_model), (n_heads * v_dim) ** -0.5)
    p.add("q_ln", (q_lora,), "ones", torch.float32)
    p.add("kv_ln", (kv_lora,), "ones", torch.float32)
    return p


def mla_forward(p, x, *, positions, rope_theta=10_000.0, make_cache=True):
    """Training/prefill path: materialize per-head K/V from the latent
    (plain attention: the head dims nope + rope and v differ)."""
    nope = p["w_uk"].shape[2]
    cq = rms_norm(torch.einsum("btd,dq->btq", x, p["w_dq"]), p["q_ln"])
    q = torch.einsum("btq,qhk->bthk", cq, p["w_uq"])
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    q_pe = apply_rope(q_pe, positions, rope_theta)

    ckv = rms_norm(torch.einsum("btd,dc->btc", x, p["w_dkv"]), p["kv_ln"])
    k_pe = apply_rope(torch.einsum("btd,dr->btr", x, p["w_kpe"])[:, :, None, :],
                      positions, rope_theta)               # (B,T,1,R)
    k_nope = torch.einsum("btc,chk->bthk", ckv, p["w_uk"])
    v = torch.einsum("btc,chk->bthk", ckv, p["w_uv"])

    h = q.shape[2]
    k_full = torch.cat(
        [k_nope, k_pe.expand(*k_pe.shape[:2], h, k_pe.shape[-1])], dim=-1)
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    bias = _mask_bias(x.shape[1], x.shape[1], 0, None, True, x.device)
    out = _sdpa(q_full, k_full, v, bias)
    out = torch.einsum("bthk,hkd->btd", out, p["wo"])
    cache = {"ckv": ckv, "k_pe": k_pe[:, :, 0, :]} if make_cache else None
    return out, cache


def mla_decode(p, x, cache, *, position, rope_theta=10_000.0, scatter=False):
    """Absorbed decode: scores against the *latent* cache (c_kv, k_pe) —
    the MLA memory/bandwidth saving is real here: cache row = kv_lora+rope
    instead of 2*H*Dh."""
    nope = p["w_uk"].shape[2]
    scale = (nope + p["w_kpe"].shape[1]) ** -0.5
    b = x.shape[0]
    pos_b = _positions(position, b, x.device)
    cq = rms_norm(torch.einsum("btd,dq->btq", x, p["w_dq"]), p["q_ln"])
    q = torch.einsum("btq,qhk->bthk", cq, p["w_uq"])
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    q_pe = apply_rope(q_pe, pos_b[:, None], rope_theta)

    ckv_new = rms_norm(torch.einsum("btd,dc->btc", x, p["w_dkv"]),
                       p["kv_ln"])
    kpe_new = apply_rope(torch.einsum("btd,dr->btr", x, p["w_kpe"])
                         [:, :, None, :], pos_b[:, None], rope_theta)[:, :, 0, :]
    write = _scatter_row if scatter else _insert_row
    ckv = write(cache["ckv"], ckv_new, pos_b)
    k_pe = write(cache["k_pe"], kpe_new, pos_b)

    # absorb W_uk into q: q_lat (B,1,H,C); scores over latent directly
    q_lat = torch.einsum("bthk,chk->bthc", q_nope, p["w_uk"])
    s_lat = torch.einsum("bthc,bTc->bhtT", q_lat.float(), ckv.float())
    s_pe = torch.einsum("bthr,bTr->bhtT", q_pe.float(), k_pe.float())
    tk = ckv.shape[1]
    cols = torch.arange(tk, device=x.device)[None, :]
    bias = torch.zeros((b, tk), dtype=torch.float32, device=x.device) \
        .masked_fill(cols > pos_b[:, None], NEG_INF)
    bias = bias[:, None, None, :]                 # (B,1,1,Tk) for bhtT
    w = torch.softmax((s_lat + s_pe) * scale + bias, dim=-1)
    o_lat = torch.einsum("bhtT,bTc->bthc", w.to(ckv.dtype), ckv)
    out = torch.einsum("bthc,chk->bthk", o_lat, p["w_uv"])
    out = torch.einsum("bthk,hkd->btd", out, p["wo"])
    return out, {"ckv": ckv, "k_pe": k_pe}
