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
calls of :func:`gqa_forward` by route.

The JAX package's sharding constraints are here, at its points, through
:func:`repro_torch.distributed.sharding.constrain`: the argument itself
without an active mesh, a DTensor redistributed under one.  Under a mesh
the flash kernel runs on each rank's local shards of q, k and v where
they are sharded over batch or heads alone, alike (:func:`prefill_route`),
and its output is wrapped back with their placements; it never receives a
DTensor.
"""

from __future__ import annotations

from collections import Counter

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..distributed.sharding import (all_reduce, all_reduce_max, as_dtensor,
                                    axis_size, constrain, local_region,
                                    redistribute, shard_span)
from ..kernels.attention import kernel as flash_kernel
from ..kernels.attention import ops as flash_ops
from ..kernels.attention.space import build_space as flash_space
from ..kernels.common import config_at
from .layers import Params, apply_rope, einsum, einsum_shared, rms_norm

NEG_INF = -1e30

#: :func:`gqa_forward`'s attention calls by route: ``"kernel:plan"`` and
#: ``"kernel:resolved"`` count the flash kernel's launches (one a sequence)
#: under the caller's config and under the one the op resolves, ``"plain"``
#: the calls of :func:`_sdpa` (one a call)
ROUTES: Counter = Counter()
#: ``attention_impl`` values: ``"auto"`` takes the kernel where
#: :func:`prefill_route` says, ``"plain"`` never does
IMPLS = ("auto", "plain")


def _tp_size() -> int:
    return axis_size("model")


def _constrain_qkv(q, k, v, *, opt: bool):
    """Beyond-paper SPMD policy (opt_attn): pin attention activations so the
    partitioner never invents full-tensor rematerializations.

    * heads divisible by TP -> heads on ``model`` (zero attention-internal
      collectives when kv heads are replicated to TP, see ``kv_repeat``);
    * otherwise -> sequence on ``model`` for q (context parallelism), k/v
      replicated across ``model`` (partial-softmax psums are tiny vs the
      full-remat copies the baseline suffers).  In the port k and v keep
      their placements: :func:`_sdpa_seq` gathers them as they enter its
      region, so their gradients return reduce-scattered to them.
    """
    if not opt:
        return q, k, v, None
    tp = _tp_size()
    h, hkv = q.shape[2], k.shape[2]
    if tp > 1 and h % tp == 0 and hkv % tp == 0:
        q = constrain(q, ("pod", "data"), None, "model", None)
        k = constrain(k, ("pod", "data"), None, "model", None)
        v = constrain(v, ("pod", "data"), None, "model", None)
        return q, k, v, "heads"
    if tp > 1 and q.shape[1] % tp == 0 and q.shape[1] > 1:
        q = constrain(q, ("pod", "data"), "model", None, None)
        return q, k, v, "seq"
    return q, k, v, None


# --------------------------------------------------------------------- #
# GQA
# --------------------------------------------------------------------- #
def make_gqa(d_model, n_heads, n_kv, d_head, qk_norm=False) -> Params:
    s = d_model ** -0.5
    p = Params()
    p.add("wq", (d_model, n_heads, d_head), s,
          axes=("embed", "heads", "head_dim"))
    p.add("wk", (d_model, n_kv, d_head), s,
          axes=("embed", "kv_heads", "head_dim"))
    p.add("wv", (d_model, n_kv, d_head), s,
          axes=("embed", "kv_heads", "head_dim"))
    p.add("wo", (n_heads, d_head, d_model), (n_heads * d_head) ** -0.5,
          axes=("heads", "head_dim", "embed"))
    if qk_norm:
        p.add("q_norm", (d_head,), "ones", torch.float32, ("head_dim",))
        p.add("k_norm", (d_head,), "ones", torch.float32, ("head_dim",))
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
    dtype for the product with v.  DTensors go through
    :func:`_sdpa_sharded`."""
    if isinstance(q, DTensor):
        return _sdpa_sharded(q, k, v, bias)
    b, tq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    q = q.reshape(b, tq, hkv, g, dh)
    logits = einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
    logits = logits * (dh ** -0.5) + bias
    w = torch.softmax(logits, dim=-1)
    out = einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
    return out.reshape(b, tq, h, v.shape[-1])


def _sdpa_sharded(q, k, v, bias):
    """:func:`_sdpa` of DTensor q, k and v on each rank's local shards:
    attention is independent across batch and heads, so a mesh dim on
    which q, k and v are all sharded over batch (dim 0) or all over heads
    (dim 2) stays so.  On one where q alone shards its heads (kv heads
    that TP does not divide), q stays so and each rank takes the kv heads
    its q heads read (gathered, then cut: whole GQA groups, or one kv head
    for a part of a group).  On any other mesh dim the three are
    replicated first (a sequence-sharded q, a pending sum).  The output
    carries q's placements as the local call ran; ``bias``, a plain
    tensor, is cut to the local batch where it has one (decode's per-slot
    rows)."""
    mesh = q.device_mesh
    heads = Shard(2)
    wq, wkv = [], []
    for pq, pk, pv in zip(q.placements, k.placements, v.placements):
        if pq == pk == pv and pq in (Shard(0), heads):
            wq.append(pq), wkv.append(pq)
        elif pq == heads:
            wq.append(pq), wkv.append(Replicate())
        else:
            wq.append(Replicate()), wkv.append(Replicate())
    lo, n = shard_span(q.shape[2], mesh, wq, 2)
    kv = slice(None)
    if shard_span(k.shape[2], mesh, wkv, 2)[1] == k.shape[2] \
            and n < q.shape[2]:
        g = q.shape[2] // k.shape[2]
        if not ((lo % g == 0 and n % g == 0) or lo // g == (lo + n - 1) // g):
            return _sdpa_sharded(*(redistribute(t, [
                Replicate() if p == heads else p for p in wq])
                for t in (q, k, v)), bias)
        kv = slice(lo // g, (lo + n - 1) // g + 1)
    ins = [(q, wq), (k, wkv), (v, wkv)]
    per_slot = bias.dim() == 5 and bias.shape[0] == q.shape[0] > 1
    if per_slot or isinstance(bias, DTensor):
        ins.append((bias, tuple(p if p == Shard(0) and per_slot
                                else Replicate() for p in wq)))
    return local_region(
        lambda lq, lk, lv, lb=bias: _sdpa(lq, lk[:, :, kv], lv[:, :, kv], lb),
        ins, wq, (*q.shape[:3], v.shape[3]))


#: opt_attn q-chunking: cap live logits at (tq/chunks x tk) per chunk.
SDPA_Q_CHUNKS = 16


def _sdpa_chunked(q, k, v, *, window, causal, offset=None):
    """Exact q-chunked attention (opt_attn, long sequences): each chunk's
    softmax sees the full key range, so only the live (tq_c x tk) logits
    block shrinks by the chunk count; the mask is built per chunk.
    ``offset``: the position of q's first row minus that of k's first
    (default: q's rows are the last of k's)."""
    tq, tk = q.shape[1], k.shape[1]
    offset = tk - tq if offset is None else offset
    n = max(1, min(SDPA_Q_CHUNKS, tq // 512))
    while tq % n:
        n -= 1
    c = tq // n
    outs = []
    for i in range(n):
        bias = _mask_bias(c, tk, offset + i * c, window, causal, q.device)
        outs.append(_sdpa(q[:, i * c:(i + 1) * c], k, v, bias))
    return torch.cat(outs, dim=1) if n > 1 else outs[0]


def _sdpa_seq(q, k, v, *, window, causal, chunked):
    """Attention of DTensor q sharded over the sequence ("seq" mode of
    :func:`_constrain_qkv`) in one local region: each rank runs its own
    rows of q (chunked as :func:`_sdpa_chunked` where ``chunked``) against
    the whole keys, its mask offset by its shard's first row; k and v
    enter whole over every mesh dim but those that shard the batch (one
    gather each), and on the way back their gradients, pending sums over
    the ranks of the rows, are reduce-scattered onto their own
    placements.  The output has q's placements."""
    mesh = q.device_mesh
    wq = [p if p in (Shard(0), Shard(1)) else Replicate()
          for p in q.placements]
    wkv = [p if p == Shard(0) else Replicate() for p in wq]
    offset = k.shape[1] - q.shape[1] + shard_span(q.shape[1], mesh, wq,
                                                  1)[0]

    def fn(lq, lk, lv):
        if chunked:
            return _sdpa_chunked(lq, lk, lv, window=window, causal=causal,
                                 offset=offset)
        return _sdpa(lq, lk, lv, _mask_bias(lq.shape[1], lk.shape[1], offset,
                                            window, causal, lq.device))

    return local_region(fn, [(q, wq), (k, wkv), (v, wkv)], wq,
                        (*q.shape[:3], v.shape[3]))


def prefill_route(q, k, *, window, causal, kv_override,
                  impl="auto", v=None) -> str:
    """``"kernel"`` where the flash kernel takes this attention, else
    ``"plain"``.  Where autograd would record through the attention
    (grad enabled and q, k or v requiring grad) it is always ``"plain"``:
    the kernel has no backward, as the JAX package's Pallas kernel has
    none and its training path runs the jnp attention.  Otherwise, under
    ``impl="auto"``, ``"kernel"`` for CUDA bf16 causal self-attention with
    Tq = Tk, no window, a head dim the kernel is built for, and a shape
    where some config of the ``flash_attention_h100`` space fits.  DTensor
    q, k and v take the kernel only where all three have the same
    placements and those shard batch or heads alone (no sequence, head
    dim or pending sum): the kernel then runs on each rank's local shards,
    and the shape checked is theirs.  Decided before anything runs; once it
    says ``"kernel"``, a failing launch raises."""
    if impl not in IMPLS:
        raise ValueError(f"attention_impl must be one of {IMPLS}, not "
                         f"{impl!r}")
    if torch.is_grad_enabled() and any(
            getattr(t, "requires_grad", False) for t in (q, k, v)):
        return "plain"
    local = _local_shards(q, k, v)
    if local is None:
        return "plain"
    q, k = local[0], local[1]
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


def _local_shards(q, k, v):
    """``(q, k, v)`` as the flash kernel would take them: the tensors
    themselves, or for DTensors their local shards where all three share
    placements that shard dims 0 (batch) and 2 (heads) alone, else
    None."""
    ts = [t for t in (q, k, v) if t is not None]
    dt = [isinstance(t, DTensor) for t in ts]
    if not any(dt):
        return q, k, v
    if not all(dt) or len({tuple(t.placements) for t in ts}) != 1 or not all(
            isinstance(p, Replicate) or (isinstance(p, Shard)
                                         and p.dim in (0, 2))
            for p in q.placements):
        return None
    return tuple(t.to_local() if t is not None else None for t in (q, k, v))


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
    resolves.  DTensors (as :func:`prefill_route` admits them) run on
    their local shards, and the output is a DTensor with q's
    placements."""
    if isinstance(q, DTensor):
        pl = q.placements
        return local_region(lambda *qkv: _flash(*qkv, config),
                            [(q, pl), (k, pl), (v, pl)], pl, q.shape)
    out = torch.empty_like(q)
    for i in range(q.shape[0]):
        qi, ki, vi = (t[i].transpose(0, 1).contiguous() for t in (q, k, v))
        if i == 0:
            cfg = admitted_config(qi, ki, vi, config)
        ROUTES["kernel:plan" if cfg else "kernel:resolved"] += 1
        out[i] = flash_ops.attention(qi, ki, vi, causal=True,
                                     config=cfg).transpose(0, 1)
    return out


def _repeat_kv(t, r: int):
    """``t``'s kv heads (dim 2) each repeated ``r`` times in place; a
    DTensor on its local shards, its placements kept (a head-sharded
    rank's heads repeat into the same rank's block)."""
    if not isinstance(t, DTensor):
        return torch.repeat_interleave(t, r, dim=2)
    pl = tuple(t.placements)
    return local_region(lambda lt: torch.repeat_interleave(lt, r, dim=2),
                        [(t, pl)], pl,
                        (*t.shape[:2], t.shape[2] * r, *t.shape[3:]))


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
    proj = "btd,dhk->bthk"
    if kv_override is None:
        q, k, v = einsum_shared(x, (proj, p["wq"]), (proj, p["wk"]),
                                (proj, p["wv"]))
    else:
        q = einsum(proj, x, p["wq"])
        k, v = einsum_shared(kv_override, (proj, p["wk"]), (proj, p["wv"]))
    if qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if rope_theta:
        q = apply_rope(q, positions, rope_theta)
        kpos = positions if kv_override is None else \
            torch.arange(k.shape[1], device=k.device)[None]
        k = apply_rope(k, kpos, rope_theta)
    if kv_repeat > 1:
        k, v = _repeat_kv(k, kv_repeat), _repeat_kv(v, kv_repeat)
    q, k, v, mode = _constrain_qkv(q, k, v, opt=opt)
    if prefill_route(q, k, window=window, causal=causal,
                     kv_override=kv_override, impl=impl, v=v) == "kernel":
        out = _flash(q, k, v, kernel_config)
    else:
        ROUTES["plain"] += 1
        chunked = opt and q.shape[1] >= 2048
        if mode == "seq" and isinstance(q, DTensor):
            out = _sdpa_seq(q, k, v, window=window, causal=causal,
                            chunked=chunked)
        elif chunked:
            out = _sdpa_chunked(q, k, v, window=window, causal=causal)
        else:
            bias = _mask_bias(q.shape[1], k.shape[1], 0, window, causal,
                              q.device)
            out = _sdpa(q, k, v, bias)
    if mode == "heads":
        out = constrain(out, ("pod", "data"), None, "model", None)
    elif mode == "seq":
        out = constrain(out, ("pod", "data"), "model", None, None)
    out = einsum("bthk,hkd->btd", out, p["wo"])
    if opt:
        out = constrain(out, ("pod", "data"), None, None)
    cache = {"k": k, "v": v} if make_cache else None
    return out, cache


def _insert_row(cache, new, insert_b):
    """Write ``new`` (B,1,...) into per-batch row ``insert_b`` of ``cache``
    (B,T,...).  One-hot blend — vectorized over the batch so every slot may
    sit at a different sequence position (continuous batching); a row
    outside ``[0, T)`` writes nothing."""
    t = cache.shape[1]
    onehot = torch.arange(t, device=cache.device)[None, :] \
        == insert_b[:, None]                                   # (B,T)
    onehot = onehot.reshape(onehot.shape + (1,) * (cache.ndim - 2))
    return torch.where(onehot, new.to(cache.dtype), cache)


def _scatter_row(cache, new, insert_b):
    """The same write as :func:`_insert_row` by indexing: one row a batch
    entry, written into ``cache`` in place (``opt_scatter_cache``).  A
    batch entry whose row lies outside ``[0, T)`` writes its row clamped
    into the cache back unchanged: nothing, as the blend and the JAX
    package's scatter (which drops it)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    t = cache.shape[1]
    held = ((insert_b >= 0) & (insert_b < t)).reshape(
        -1, *(1,) * (new.ndim - 2))
    insert_b = insert_b.clamp(0, t - 1)
    cache[rows, insert_b] = torch.where(held, new[:, 0].to(cache.dtype),
                                        cache[rows, insert_b])
    return cache


def _write_row(cache, new, insert_b, scatter: bool):
    """``new`` (B,1,...) written into row ``insert_b`` (B,) of ``cache``
    (B,T,...) by :func:`_scatter_row` (``scatter``) or
    :func:`_insert_row`.  A DTensor cache is written in one local region
    on its own placements: each rank writes its batch rows, and its heads
    or channels, into its local shard, and where a mesh dim shards the
    sequence, only the rank that holds a row writes it (the row lies
    outside every other rank's shard).  ``new`` enters with the cache's
    batch and trailing shards and whole over the sequence's mesh dims, so
    the write itself sends nothing: the one collective is ``new``'s own
    move to those placements, where it has others."""
    write = _scatter_row if scatter else _insert_row
    if not isinstance(cache, DTensor):
        return write(cache, new, insert_b)
    mesh = cache.device_mesh
    cw = tuple(Replicate() if p.is_partial() else p for p in cache.placements)
    nw = tuple(Replicate() if p == Shard(1) else p for p in cw)
    bw = tuple(p if p == Shard(0) else Replicate() for p in cw)
    lo, n = shard_span(cache.shape[1], mesh, cw, 1)
    return local_region(
        lambda lc, ln, lb: write(lc, ln, lb - lo) if n else lc,
        [(cache, cw), (new, nw), (insert_b, bw)], cw, cache.shape)


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
    kv heads (see gqa_forward), so it shards cleanly over TP.  ``opt``
    pins the cache and the output (:func:`constrain`).
    """
    b = x.shape[0]
    pos_b = _positions(position, b, x.device)
    ins_b = pos_b if insert_at is None else \
        _positions(insert_at, b, x.device)
    q = einsum("btd,dhk->bthk", x, p["wq"])
    k_new = einsum("btd,dhk->bthk", x, p["wk"])
    v_new = einsum("btd,dhk->bthk", x, p["wv"])
    if qk_norm:
        q = rms_norm(q, p["q_norm"])
        k_new = rms_norm(k_new, p["k_norm"])
    if rope_theta:
        q = apply_rope(q, pos_b[:, None], rope_theta)
        k_new = apply_rope(k_new, pos_b[:, None], rope_theta)
    if kv_repeat > 1:
        k_new = _repeat_kv(k_new, kv_repeat)
        v_new = _repeat_kv(v_new, kv_repeat)
    if opt:
        tp = _tp_size()
        hkv = k_new.shape[2]
        spec = (("pod", "data"), None, "model", None) \
            if (tp > 1 and hkv % tp == 0) \
            else (("pod", "data"), "model", None, None)
        cache = {"k": constrain(cache["k"], *spec),
                 "v": constrain(cache["v"], *spec)}
    k = _write_row(cache["k"], k_new, ins_b, scatter)
    v = _write_row(cache["v"], v_new, ins_b, scatter)
    bias = _decode_bias(pos_b, 0, k.shape[1])[:, None]  # (B,1,1,1,Tk)
    out = _sdpa(q, k, v, bias)
    out = einsum("bthk,hkd->btd", out, p["wo"])
    if opt:
        out = constrain(out, ("pod", "data"), None, None)
    return out, {"k": k, "v": v}


# --------------------------------------------------------------------- #
# MLA (DeepSeek-V2 multi-head latent attention)
# --------------------------------------------------------------------- #
def make_mla(d_model, n_heads, *, kv_lora=512, q_lora=1536, nope_dim=128,
             rope_dim=64, v_dim=None) -> Params:
    v_dim = v_dim if v_dim is not None else nope_dim
    s = d_model ** -0.5
    p = Params()
    p.add("w_dq", (d_model, q_lora), s, axes=("embed", "q_lora"))
    p.add("w_uq", (q_lora, n_heads, nope_dim + rope_dim), q_lora ** -0.5,
          axes=("q_lora", "heads", "head_dim"))
    p.add("w_dkv", (d_model, kv_lora), s, axes=("embed", "kv_lora"))
    p.add("w_kpe", (d_model, rope_dim), s, axes=("embed", "head_dim"))
    p.add("w_uk", (kv_lora, n_heads, nope_dim), kv_lora ** -0.5,
          axes=("kv_lora", "heads", "head_dim"))
    p.add("w_uv", (kv_lora, n_heads, v_dim), kv_lora ** -0.5,
          axes=("kv_lora", "heads", "head_dim"))
    p.add("wo", (n_heads, v_dim, d_model), (n_heads * v_dim) ** -0.5,
          axes=("heads", "head_dim", "embed"))
    p.add("q_ln", (q_lora,), "ones", torch.float32, ("q_lora",))
    p.add("kv_ln", (kv_lora,), "ones", torch.float32, ("kv_lora",))
    return p


def _mla_down(p, x):
    """MLA's three down-projections of ``x``: the q latent, the kv latent
    and the shared RoPE key (one activation, :func:`einsum_shared`)."""
    return einsum_shared(x, ("btd,dq->btq", p["w_dq"]),
                         ("btd,dc->btc", p["w_dkv"]),
                         ("btd,dr->btr", p["w_kpe"]))


def _mla_keys(k_nope, k_pe):
    """MLA's keys: each head's ``k_nope`` (B,T,H,N) beside the one shared
    RoPE key ``k_pe`` (B,T,1,R).  DTensors on their local shards: the
    heads keep their batch, sequence or head shards (a shard of N is
    gathered), and ``k_pe`` is gathered over the mesh dims where the heads
    are sharded (its gradient, a sum over the heads, reduce-scattered back
    there): it is H times smaller than the keys it fills."""
    if not isinstance(k_nope, DTensor) and not isinstance(k_pe, DTensor):
        h = k_nope.shape[2]
        return torch.cat(
            [k_nope, k_pe.expand(*k_pe.shape[:2], h, k_pe.shape[-1])], dim=-1)
    mesh = (k_nope if isinstance(k_nope, DTensor) else k_pe).device_mesh
    k_nope, k_pe = as_dtensor(k_nope, mesh), as_dtensor(k_pe, mesh)
    kw = [p if p in (Shard(0), Shard(1), Shard(2)) else Replicate()
          for p in k_nope.placements]
    pw = [p if p in (Shard(0), Shard(1)) else Replicate() for p in kw]
    return local_region(
        _mla_keys, [(k_nope, kw), (k_pe, pw)], kw,
        (*k_nope.shape[:3], k_nope.shape[3] + k_pe.shape[3]))


def mla_forward(p, x, *, positions, rope_theta=10_000.0, make_cache=True):
    """Training/prefill path: materialize per-head K/V from the latent
    (plain attention: the head dims nope + rope and v differ)."""
    nope = p["w_uk"].shape[2]
    dq, dkv, kpe = _mla_down(p, x)
    cq = rms_norm(dq, p["q_ln"])
    q = einsum("btq,qhk->bthk", cq, p["w_uq"])
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    q_pe = apply_rope(q_pe, positions, rope_theta)

    ckv = rms_norm(dkv, p["kv_ln"])
    k_pe = apply_rope(kpe[:, :, None, :], positions, rope_theta)  # (B,T,1,R)
    k_nope = einsum("btc,chk->bthk", ckv, p["w_uk"])
    v = einsum("btc,chk->bthk", ckv, p["w_uv"])

    k_full = _mla_keys(k_nope, k_pe)
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    bias = _mask_bias(x.shape[1], x.shape[1], 0, None, True, x.device)
    out = _sdpa(q_full, k_full, v, bias)
    out = einsum("bthk,hkd->btd", out, p["wo"])
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
    dq, dkv, kpe = _mla_down(p, x)
    cq = rms_norm(dq, p["q_ln"])
    q = einsum("btq,qhk->bthk", cq, p["w_uq"])
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    q_pe = apply_rope(q_pe, pos_b[:, None], rope_theta)

    ckv_new = rms_norm(dkv, p["kv_ln"])
    kpe_new = apply_rope(kpe[:, :, None, :], pos_b[:, None],
                         rope_theta)[:, :, 0, :]
    ckv = _write_row(cache["ckv"], ckv_new, pos_b, scatter)
    k_pe = _write_row(cache["k_pe"], kpe_new, pos_b, scatter)

    # absorb W_uk into q: q_lat (B,1,H,C); scores over latent directly
    q_lat = einsum("bthk,chk->bthc", q_nope, p["w_uk"])
    o_lat = _mla_attend(q_lat, q_pe, ckv, k_pe, pos_b, scale)
    out = einsum("bthc,chk->bthk", o_lat, p["w_uv"])
    out = einsum("bthk,hkd->btd", out, p["wo"])
    return out, {"ckv": ckv, "k_pe": k_pe}


def _mla_attend(q_lat, q_pe, ckv, k_pe, pos_b, scale):
    """MLA's absorbed decode attention: the (B,1,H,C) latent output of
    one query token's scores against the latent cache ``ckv`` (B,T,C) and
    the RoPE keys ``k_pe`` (B,T,R), rows past ``pos_b`` masked.  DTensors
    through :func:`_mla_attend_sharded`."""
    if any(isinstance(t, DTensor) for t in (q_lat, q_pe, ckv, k_pe)):
        return _mla_attend_sharded(q_lat, q_pe, ckv, k_pe, pos_b, scale)
    s_lat = einsum("bthc,bTc->bhtT", q_lat.float(), ckv.float())
    s_pe = einsum("bthr,bTr->bhtT", q_pe.float(), k_pe.float())
    w = torch.softmax((s_lat + s_pe) * scale + _decode_bias(pos_b, 0,
                                                            ckv.shape[1]),
                      dim=-1)
    return einsum("bhtT,bTc->bthc", w.to(ckv.dtype), ckv)


def _decode_bias(pos_b, lo: int, n: int):
    """(B,1,1,n) additive mask of cache rows ``lo .. lo + n`` past each
    batch entry's position ``pos_b`` (valid: rows up to the position)."""
    cols = torch.arange(lo, lo + n, device=pos_b.device)[None, :]
    bias = torch.zeros((pos_b.shape[0], n), dtype=torch.float32,
                       device=pos_b.device).masked_fill(
                           cols > pos_b[:, None], NEG_INF)
    return bias[:, None, None, :]                 # (B,1,1,Tk) for bhtT


def _mla_attend_sharded(q_lat, q_pe, ckv, k_pe, pos_b, scale):
    """:func:`_mla_attend` in one local region over the shards the cache
    already has, mesh dim by mesh dim: where the cache shards the batch,
    everything does; where it shards the sequence, each rank scores its
    own rows against the whole query (gathered over that dim: one token's
    H x (C + R), where the cache would be T x C), the softmax's max and
    sum are all-reduced over it, and each rank's weighted rows leave as a
    pending sum of the output, reduced on the way out; where the cache is
    whole, a head-sharded query keeps its heads.  Nothing of the cache
    moves.  Without a sequence-sharding dim the local ops are
    :func:`_mla_attend`'s own."""
    mesh = next(t.device_mesh for t in (q_lat, q_pe, ckv, k_pe)
                if isinstance(t, DTensor))
    ckv, k_pe = as_dtensor(ckv, mesh), as_dtensor(k_pe, mesh)
    q_lat = as_dtensor(q_lat, mesh)
    cw, qw, ow, seq = [], [], [], []
    for i, (pc, pq) in enumerate(zip(ckv.placements, q_lat.placements)):
        if pc == Shard(0):
            cw.append(pc), qw.append(pc), ow.append(pc)
        elif pc == Shard(1):
            cw.append(pc), qw.append(Replicate()), ow.append(Partial())
            seq.append(i)
        elif pq == Shard(2):
            cw.append(Replicate()), qw.append(pq), ow.append(pq)
        else:
            cw.append(Replicate()), qw.append(Replicate()), \
                ow.append(Replicate())
    bw = [p if p == Shard(0) else Replicate() for p in cw]
    lo, n = shard_span(ckv.shape[1], mesh, cw, 1)

    def fn(lq, lqp, lc, lk, lp):
        if not seq:
            return _mla_attend(lq, lqp, lc, lk, lp, scale)
        s_lat = einsum("bthc,bTc->bhtT", lq.float(), lc.float())
        s_pe = einsum("bthr,bTr->bhtT", lqp.float(), lk.float())
        z = (s_lat + s_pe) * scale + _decode_bias(lp, lo, n)
        m = all_reduce_max(z.detach().amax(-1, keepdim=True), mesh, seq)
        e = torch.exp(z - m)
        w = e / all_reduce(e.sum(-1, keepdim=True), mesh, seq)
        return einsum("bhtT,bTc->bthc", w.to(lc.dtype), lc)

    return local_region(
        fn, [(q_lat, qw), (q_pe, qw), (ckv, cw), (k_pe, cw), (pos_b, bw)],
        ow, (*q_lat.shape[:3], ckv.shape[2]))
