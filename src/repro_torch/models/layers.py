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

from ..distributed.sharding import as_dtensor, local_region, shard_span

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


def _einsum_sharded(equation: str, a, b):
    """A two-operand einsum of DTensors on each rank's local shards, by the
    SPMD rules, mesh dim by mesh dim: where ``a`` (the activation in the
    models' products) shards a letter, ``b`` is made to fit it (gathered
    where the letter is ``a``'s alone, cut to the same letter where they
    share it); where only ``b`` shards one, ``a`` is cut to match if they
    share it.  A letter kept in the output leaves the result sharded on
    it; a contracted one leaves a pending sum, which the region reduces
    (:func:`~repro_torch.distributed.sharding.local_region`).  The local
    product is ``torch.einsum``, so no strided shard or permuted layout
    reaches DTensor's own views."""
    (la, lb), out = _letters(equation, (a, b))
    mesh = a.device_mesh if isinstance(a, DTensor) else b.device_mesh
    a, b = as_dtensor(a, mesh), as_dtensor(b, mesh)
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
    return local_region(
        lambda x, y: torch.einsum(f"{la},{lb}->{out}", x, y),
        [(a, pa), (b, pb)], po, [size[c] for c in out])


def rms_norm(x, w, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w).to(x.dtype)


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
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)            # (Dh/2,)
    ang = positions[..., :, None].float() * freqs            # (..., T, Dh/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., T, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


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
        h = einsum("...d,df->...f", x, p["wi"])
        g = einsum("...d,df->...f", x, p["wg"])
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
