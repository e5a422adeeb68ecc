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

PTREE_DTYPE = torch.bfloat16          # parameter storage dtype


class Params(nn.Module):
    """A node of the parameter tree: named parameters and child nodes,
    read as ``p["name"]`` and tested with ``"name" in p``.

    :meth:`add` registers an empty parameter with its initialiser:
    ``scale`` a float draws N(0, 1) in f32 times ``scale`` (the JAX
    ``_init``), ``"ones"`` fills ones and ``"eye"`` the identity."""

    def __init__(self):
        super().__init__()
        self.rules: dict[str, float | str] = {}

    def add(self, name: str, shape: tuple, scale: float | str,
            dtype: torch.dtype = PTREE_DTYPE) -> None:
        self.rules[name] = scale
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
    p.add(name, (d,), "ones", torch.float32)


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
    p.add("wi", (d_model, d_ff), d_model ** -0.5)
    if kind == "swiglu":
        p.add("wg", (d_model, d_ff), d_model ** -0.5)
    p.add("wo", (d_ff, d_model), d_ff ** -0.5)
    return p


def mlp(p, x, kind="swiglu"):
    if kind == "swiglu":
        h = torch.einsum("...d,df->...f", x, p["wi"])
        g = torch.einsum("...d,df->...f", x, p["wg"])
        h = F.silu(g.float()).to(x.dtype) * h
    elif kind == "relu2":                   # RWKV channel-mix style
        h = torch.einsum("...d,df->...f", x, p["wi"])
        h = torch.square(F.relu(h.float())).to(x.dtype)
    else:                                   # gelu
        h = torch.einsum("...d,df->...f", x, p["wi"])
        h = gelu(h.float()).to(x.dtype)
    return torch.einsum("...f,fd->...d", h, p["wo"])


# --------------------------------------------------------------------- #
# embeddings / unembedding
# --------------------------------------------------------------------- #
def make_embedding(p: Params, vocab, d_model) -> None:
    p.add("embedding", (vocab, d_model), 1.0)


def embed(table, tokens):
    return table[tokens]


def unembed(table, x):
    """Tied unembedding: logits in f32 (loss numerics), scaled by 1/sqrt(d)
    (T5/PaLM convention — keeps the initial nll near ln(vocab))."""
    return torch.einsum("...d,vd->...v", x.float(), table.float()) \
        * (table.shape[1] ** -0.5)
