"""Core layers in PyTorch: norms, RoPE, MLPs, embeddings.

The port of ``repro.models.layers``.  Parameters live in :class:`Params`
nodes, ``nn.Module``s that a layer function reads as ``p["name"]``, as the
JAX package reads its dicts.  A node is built with empty tensors on the
``meta`` device, so that building a full-width model costs no memory, and
records how each parameter is initialised; :func:`init_params` (what
``Model.init`` calls) fills them all on their device from one
``torch.Generator``.  Storage
dtypes are the JAX package's: bf16 (:data:`PTREE_DTYPE`) for weights, f32
for norms and the few parameters it keeps in f32, and every function casts
to f32 where the JAX function casts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..distributed.sharding import (all_reduce, as_dtensor, local_region,
                                    shard_span, swap_halves)

PTREE_DTYPE = torch.bfloat16          # parameter storage dtype


class Params(nn.Module):
    """A node of the parameter tree: named parameters and child nodes,
    read as ``p["name"]`` and tested with ``"name" in p``.

    :meth:`add` registers an empty parameter with its initialiser:
    ``scale`` a float draws N(0, 1) in f32 times ``scale`` (the JAX
    ``_init``), ``"ones"`` fills ones and ``"eye"`` the identity; ``axes``
    are the parameter's logical axes, one a dim, the JAX creator's
    ``axes`` entry (``repro_torch.distributed.sharding`` maps them to
    mesh axes)."""

    def __init__(self):
        super().__init__()
        self.rules: dict[str, float | str] = {}
        self.axes: dict[str, tuple] = {}

    def add(self, name: str, shape: tuple, scale: float | str,
            dtype: torch.dtype = PTREE_DTYPE, axes: tuple = ()) -> None:
        if len(axes) != len(shape):
            raise ValueError(f"{name}: axes {axes} for shape {shape}")
        self.rules[name] = scale
        self.axes[name] = tuple(axes)
        self.register_parameter(name, nn.Parameter(
            torch.empty(shape, dtype=dtype, device="meta")))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    @torch.no_grad()
    def fill(self, gen: torch.Generator) -> None:
        """Initialise this node's own parameters, in the order they were
        added, from ``gen`` (a generator on their device)."""
        for name, rule in self.rules.items():
            p = self._parameters[name]
            if rule == "ones":
                p.fill_(1.0)
            elif rule == "eye":
                p.copy_(torch.eye(*p.shape, device=p.device))
            else:
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device,
                                    dtype=torch.float32).mul_(rule))


def init_params(module: nn.Module, seed: int, device) -> nn.Module:
    """Give every parameter of ``module`` storage on ``device`` and fill
    each :class:`Params` node in turn from one generator there, seeded with
    ``seed``: nothing is built on the host and copied over."""
    device = torch.device(device)
    module.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for node in module.modules():
        if isinstance(node, Params):
            node.fill(gen)
    return module


def norm_param(p: Params, name: str, d: int) -> None:
    p.add(name, (d,), "ones", torch.float32, ("embed",))


def einsum(equation: str, *operands):
    """``torch.einsum``; with DTensor operands, :func:`_einsum_sharded`
    (on plain tensors nothing changes)."""
    if any(isinstance(x, DTensor) for x in operands):
        return _einsum_sharded(equation, *operands)
    return torch.einsum(equation, *operands)


def _letters(equation: str, operands) -> tuple[list[str], str]:
    """The operands' and the output's letters, ``...`` spelled out."""
    ins, out = equation.replace(" ", "").split("->")
    specs = ins.split(",")
    spare = iter(c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 if c not in equation)
    ell = ""
    for k, s in enumerate(specs):
        if "..." in s:
            n = operands[k].dim() - (len(s) - 3)
            ell = ell or "".join(next(spare) for _ in range(n))
            specs[k] = s.replace("...", ell[len(ell) - n:])
    return specs, out.replace("...", ell)


def _plan(equation: str, a, b):
    """The placements of one two-operand einsum of DTensors on their local
    shards, by the SPMD rules, mesh dim by mesh dim: where ``a`` (the
    activation in the models' products) shards a letter, ``b`` is made to
    fit it (gathered where the letter is ``a``'s alone, cut to the same
    letter where they share it); where only ``b`` shards one, ``a`` is cut
    to match if they share it.  A letter kept in the output leaves the
    result sharded on it; a contracted one leaves a pending sum.  Returns
    the local equation, ``a``'s, ``b``'s and the result's placements and
    the result's global shape."""
    (la, lb), out = _letters(equation, (a, b))
    pa, pb, po = [], [], []
    for qa, qb in zip(a.placements, b.placements):
        ca = la[qa.dim] if isinstance(qa, Shard) else None
        cb = lb[qb.dim] if isinstance(qb, Shard) else None
        if ca is None and cb is not None and cb in la:
            ca = cb                                # cut a to b's letter
        if ca is not None:
            cb = ca if ca in lb else None
        pa.append(Shard(la.index(ca)) if ca else Replicate())
        pb.append(Shard(lb.index(cb)) if cb else Replicate())
        c = ca or cb
        po.append(Replicate() if c is None else
                  Shard(out.index(c)) if c in out else Partial())
    size = {**dict(zip(la, a.shape)), **dict(zip(lb, b.shape))}
    return f"{la},{lb}->{out}", pa, pb, po, [size[c] for c in out]


def _einsum_sharded(equation: str, a, b):
    """A two-operand einsum of DTensors on each rank's local shards, placed
    by :func:`_plan`; the pending sum of a contracted letter is reduced by
    the region (:func:`~repro_torch.distributed.sharding.local_region`).
    The local product is ``torch.einsum``, so no strided shard or permuted
    layout reaches DTensor's own views."""
    mesh = a.device_mesh if isinstance(a, DTensor) else b.device_mesh
    a, b = as_dtensor(a, mesh), as_dtensor(b, mesh)
    eq, pa, pb, po, shape = _plan(equation, a, b)
    return local_region(lambda x, y: torch.einsum(eq, x, y),
                        [(a, pa), (b, pb)], po, shape)


def einsum_shared(x, *products):
    """``[einsum(eq, x, w) for eq, w in products]``: several products of
    one activation ``x``.  With DTensor operands, the products whose
    :func:`_plan` takes ``x`` under the same placements run in one local
    region, which ``x`` enters once: the backward then sums their local
    gradients of ``x`` before it reduces them, one all-reduce where one a
    product would be as many.  On plain tensors it is the same
    ``torch.einsum`` calls in the same order."""
    ws = [w for _, w in products]
    if not any(isinstance(t, DTensor) for t in (x, *ws)):
        return [torch.einsum(eq, x, w) for eq, w in products]
    mesh = next(t.device_mesh for t in (x, *ws) if isinstance(t, DTensor))
    x = as_dtensor(x, mesh)
    plans = [_plan(eq, x, as_dtensor(w, mesh)) for eq, w in products]
    out = [None] * len(products)
    groups: dict[tuple, list[int]] = {}
    for j, plan in enumerate(plans):
        groups.setdefault(tuple(plan[1]), []).append(j)
    for pa, js in groups.items():
        def fn(lx, *lws, js=js):
            return [torch.einsum(plans[j][0], lx, lw)
                    for j, lw in zip(js, lws)]
        res = local_region(
            fn, [(x, pa)] + [(as_dtensor(ws[j], mesh), plans[j][2])
                             for j in js],
            [plans[j][3] for j in js], [plans[j][4] for j in js])
        for j, r in zip(js, res):
            out[j] = r
    return out


def scan_chunks(fn, state, xs, consts, max_chunk: int):
    """A recurrence chunk by chunk: ``fn(state, *chunk_xs, *consts) ->
    (state, out)`` over each chunk of tokens (dim 1) of the (B, T, ...)
    ``xs`` in turn, a chunk the largest divisor of T not above
    ``max_chunk``; returns the last state and the outputs joined on dim
    1.  Under a step tracer on fake tensors it runs the first chunk and
    counts the rest (:meth:`repro_torch.roofline.trace.StepTracer.
    scan_once`); otherwise every token runs."""
    from ..roofline.trace import once_tracer
    t = xs[0].shape[1]
    chunk = min(max_chunk, t)
    while t % chunk:
        chunk -= 1
    tracer = once_tracer(state, *xs, *consts) if t > chunk else None
    if tracer is not None:
        return tracer.scan_once(fn, state, xs, consts, chunk)
    outs = []
    for c in range(0, t, chunk):
        state, o = fn(state, *(x[:, c:c + chunk] for x in xs), *consts)
        outs.append(o)
    return state, torch.cat(outs, dim=1)


def rms_norm(x, w, eps=1e-6):
    """RMS norm over the last dim, weighted by ``w``; DTensors through
    :func:`_rms_norm_sharded`."""
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        return _rms_norm_sharded(x, w, eps)
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w).to(x.dtype)


def _rms_norm_sharded(x, w, eps):
    """:func:`rms_norm` on each rank's local shards: ``x`` keeps its
    placements, and ``w`` enters as the shard of the last dim that ``x``
    holds (gathered where ``x`` holds it whole: an FSDP-sharded norm weight
    is gathered once for the forward, and its gradient reduce-scattered
    on the way back).  Where no mesh dim shards the last dim the local
    ops are :func:`rms_norm`'s own; where one does, the mean is the local
    sum of squares, (..., 1) in f32, summed over those mesh dims by one
    all-reduce each (and its gradient so on the way back), never a gather
    of ``x``."""
    mesh = (x if isinstance(x, DTensor) else w).device_mesh
    x, w = as_dtensor(x, mesh), as_dtensor(w, mesh)
    last = Shard(x.ndim - 1)
    xw = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    ww = [Shard(0) if p == last else Replicate() for p in xw]
    dims = [i for i, p in enumerate(xw) if p == last]
    d = x.shape[-1]

    def fn(lx, lw):
        if not dims:
            return rms_norm(lx, lw, eps)
        x32 = lx.float()
        ss = all_reduce(torch.sum(x32 * x32, dim=-1, keepdim=True), mesh,
                        dims)
        return (x32 * torch.rsqrt(ss / d + eps) * lw).to(lx.dtype)

    return local_region(fn, [(x, xw), (w, ww)], xw, x.shape)


# --------------------------------------------------------------------- #
# rotary position embedding
# --------------------------------------------------------------------- #
def rope_frequencies(d_head: int, theta: float = 10_000.0, device=None):
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x, positions, theta: float = 10_000.0):
    """``x``: (..., T, H, Dh); ``positions``: broadcastable to (..., T).
    The two halves of Dh rotate as a pair (concatenated, not
    interleaved)."""
    if isinstance(x, DTensor):
        return _rope_sharded(x, positions, theta)
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)            # (Dh/2,)
    ang = positions[..., :, None].float() * freqs            # (..., T, Dh/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., T, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _rope_sharded(x, positions, theta):
    """:func:`apply_rope` of DTensor ``x`` on each rank's local shards, ``x``
    keeping its placements; ``positions`` is cut where ``x`` shards a dim
    it spans.  Where no mesh dim shards the head dim, the local ops are
    :func:`apply_rope`'s own.  Where one mesh dim of even size ``n`` does
    (kv heads that the model axis does not divide), rank ``c`` holds a
    slice of one half and rank ``c + n/2 mod n`` the slice it rotates
    with: the two exchange their f32 shards by one permute (and the
    gradients by the same permute back), and each computes its own half
    of the pair, the same products as the whole.  Otherwise the head dim
    is gathered on the way in and cut on the way out (its gradient
    reduce-scattered)."""
    mesh = x.device_mesh
    xw = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    positions = as_dtensor(positions, mesh)
    last, lead = x.ndim - 1, x.ndim - 2 - positions.ndim
    pw = [Shard(p.dim - lead) if isinstance(p, Shard) and 0 <= p.dim - lead
          < positions.ndim and positions.shape[p.dim - lead]
          == x.shape[p.dim] else Replicate() for p in xw]
    dims = [i for i, p in enumerate(xw) if p == Shard(last)]
    dh = x.shape[-1]
    if not dims:
        return local_region(lambda lx, lp: apply_rope(lx, lp, theta),
                            [(x, xw), (positions, pw)], xw, x.shape)
    n = mesh.shape[dims[0]]
    if len(dims) > 1 or n % 2 or dh % n:
        gw = [Replicate() if p == Shard(last) else p for p in xw]
        lo, w = shard_span(dh, mesh, xw, last)
        return local_region(
            lambda lx, lp: apply_rope(lx, lp, theta)[..., lo:lo + w],
            [(x, gw), (positions, pw)], xw, x.shape)
    i = dims[0]
    w = dh // n
    c = mesh.get_local_rank(i)
    first = c < n // 2
    lo = (c % (n // 2)) * w

    def fn(lx, lp):
        freqs = rope_frequencies(dh, theta, lx.device)[lo:lo + w]
        ang = lp[..., :, None].float() * freqs
        cos = torch.cos(ang)[..., None, :]
        sin = torch.sin(ang)[..., None, :]
        x32 = lx.float()
        other = swap_halves(x32, mesh, i)
        out = x32 * cos - other * sin if first else other * sin + x32 * cos
        return out.to(lx.dtype)

    return local_region(fn, [(x, xw), (positions, pw)], xw, x.shape)


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# --------------------------------------------------------------------- #
# MLPs
# --------------------------------------------------------------------- #
def make_mlp(d_model, d_ff, kind="swiglu") -> Params:
    p = Params()
    p.add("wi", (d_model, d_ff), d_model ** -0.5, axes=("embed", "ff"))
    if kind == "swiglu":
        p.add("wg", (d_model, d_ff), d_model ** -0.5, axes=("embed", "ff"))
    p.add("wo", (d_ff, d_model), d_ff ** -0.5, axes=("ff", "embed"))
    return p


def mlp(p, x, kind="swiglu"):
    if kind == "swiglu":
        h, g = einsum_shared(x, ("...d,df->...f", p["wi"]),
                             ("...d,df->...f", p["wg"]))
        h = F.silu(g.float()).to(x.dtype) * h
    elif kind == "relu2":                   # RWKV channel-mix style
        h = einsum("...d,df->...f", x, p["wi"])
        h = torch.square(F.relu(h.float())).to(x.dtype)
    else:                                   # gelu
        h = einsum("...d,df->...f", x, p["wi"])
        h = gelu(h.float()).to(x.dtype)
    return einsum("...f,fd->...d", h, p["wo"])


# --------------------------------------------------------------------- #
# embeddings / unembedding
# --------------------------------------------------------------------- #
def make_embedding(p: Params, vocab, d_model) -> None:
    p.add("embedding", (vocab, d_model), 1.0, axes=("vocab", "embed"))


def embed(table, tokens):
    """Rows ``tokens`` of ``table``; DTensors through
    :func:`_embed_sharded`."""
    if isinstance(table, DTensor):
        return _embed_sharded(table, tokens)
    return table[tokens]


def _embed_sharded(table, tokens):
    """The lookup on each rank's local shards, mesh dim by mesh dim: where
    the tokens are sharded the table is gathered and the rows keep their
    sharding; where they are replicated a table sharded over its vocab
    looks up the rows it holds (the others zero) into a pending sum, and
    one sharded over its embed dim gives an embed-sharded result."""
    mesh = table.device_mesh
    tokens = as_dtensor(tokens, mesh)
    tw, kw, ow = [], [], []
    for pt, pk in zip(table.placements, tokens.placements):
        rep = Replicate()
        if isinstance(pk, Shard):
            tw.append(rep), kw.append(pk), ow.append(pk)
        elif pt == Shard(0):
            tw.append(pt), kw.append(rep), ow.append(Partial())
        elif pt == Shard(1):
            tw.append(pt), kw.append(rep), ow.append(Shard(2))
        else:
            tw.append(rep), kw.append(rep), ow.append(rep)
    lo, n = shard_span(table.shape[0], mesh, tw, 0)

    def lookup(lt, lk):
        if n == table.shape[0]:
            return lt[lk]
        held = (lk >= lo) & (lk < lo + n)
        return lt[(lk - lo).clamp(0, n - 1)] * held[..., None].to(lt.dtype)

    return local_region(lookup, [(table, tw), (tokens, kw)], ow,
                        (*tokens.shape, table.shape[1]))


def unembed(table, x):
    """Tied unembedding: logits in f32 (loss numerics), scaled by 1/sqrt(d)
    (T5/PaLM convention — keeps the initial nll near ln(vocab))."""
    return einsum("...d,vd->...v", x.float(), table.float()) \
        * (table.shape[1] ** -0.5)
