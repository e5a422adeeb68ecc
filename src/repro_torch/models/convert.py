"""The JAX package's weights and decode caches as the port's.

The JAX package stacks the pattern's blocks on a group axis (``params
["blocks"]``: one tree per pattern position, each leaf led by the group;
``params["rest"]``: the unrolled remainder layers; ``params["encoder"]``:
the encoder's layers, stacked) and lays its caches out the same way.  The
port keeps one block, and one cache entry, a layer: layer ``g * P + i`` is
pattern position ``i`` of group ``g``, and remainder layer ``j`` follows
the ``G * P`` grouped ones.  Nothing here imports JAX: the trees arrive as
nested dicts, lists and tuples of arrays (numpy's, or anything
``np.asarray`` reads; bf16 leaves are read through f32, which is exact).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .transformer import ModelConfig


def _tensor(leaf) -> torch.Tensor:
    a = np.asarray(leaf)
    if a.dtype.kind not in "biu":          # floats, ml_dtypes' bf16 too
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _take(tree, g: int):
    """``tree`` with every leaf's leading axis indexed at ``g``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _take(v, g) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_take(v, g) for v in tree)
    return np.asarray(tree)[g]


def _flatten(prefix: str, tree, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}.{k}" if prefix else k, v, out)
    else:
        out[prefix] = _tensor(tree)


def _layers(cfg: ModelConfig, groups, rest) -> list:
    """The per-layer trees of a grouped (``groups``) and remainder
    (``rest``) layout, in layer order."""
    p = len(cfg.pattern)
    n_groups = cfg.n_layers // p
    out: list[Any] = [None] * cfg.n_layers
    for i, tree in enumerate(groups or ()):
        for g in range(n_groups):
            out[g * p + i] = _take(tree, g)
    for j, tree in enumerate(rest or ()):
        out[n_groups * p + j] = tree
    return out


def from_jax_params(cfg: ModelConfig, params) -> dict[str, torch.Tensor]:
    """The JAX ``Model.init`` tree as a state dict of :class:`~.model.Model`
    (f32 where the leaves were bf16: ``load_state_dict`` casts them back
    into the bf16 parameters, exactly)."""
    state: dict[str, torch.Tensor] = {}
    for name in ("embedding", "final_norm", "enc_norm", "patch_proj"):
        if name in params:
            state[name] = _tensor(params[name])
    for i, tree in enumerate(_layers(cfg, params.get("blocks"),
                                     params.get("rest"))):
        _flatten(f"blocks.{i}", tree, state)
    for j in range(cfg.n_enc_layers):
        _flatten(f"encoder.{j}", _take(params["encoder"], j), state)
    return state


def _torch_tree(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_torch_tree(v) for v in tree)
    return _tensor(tree)


def cache_from_jax(cfg: ModelConfig, caches) -> list:
    """The JAX package's caches as the port's, on the CPU (one entry a
    layer): ``init_cache``'s ``{"groups": ..., "rest": ...}`` or the
    ``(groups, rest)`` pair that ``forward``/``prefill`` return.  Attention
    caches and the recurrent blocks' last-token states are bf16, the
    recurrent states f32, as the JAX package keeps them."""
    groups, rest = (caches["groups"], caches["rest"]) \
        if isinstance(caches, dict) else caches
    out = []
    for layer in _layers(cfg, groups, rest):
        c = _torch_tree(layer)
        if c.get("mixer") is not None:
            state, last = c["mixer"]
            c["mixer"] = (state.float(), last.to(torch.bfloat16))
        elif c.get("attn") is not None:
            c["attn"] = {k: v.to(torch.bfloat16)
                         for k, v in c["attn"].items()}
        out.append(c)
    return out
