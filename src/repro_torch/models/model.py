"""The public Model API: init / forward / train_loss / prefill / decode_step.

The port of ``repro.models.model``.  Where the JAX package stacks the
pattern's parameters on a group axis and scans them, a :class:`Model` is
an ``nn.Module`` with one block a layer (``blocks``, an ``nn.ModuleList``),
and its decode cache is a list with one entry a layer.  It is built on the
``meta`` device; :meth:`Model.init` gives it random weights on its device
(the card unless the caller asks for the CPU) and :meth:`Model.load_jax`
the JAX package's (:mod:`.convert`).
"""

from __future__ import annotations

import copy
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ..device import resolve
from ..distributed.sharding import (as_dtensor, constrain, local_region,
                                    shard_span)
from .attention import IMPLS
from .layers import (Params, einsum, embed, init_params, make_embedding,
                     norm_param, rms_norm, unembed)
from .rglru import CONV_WIDTH
from .rwkv6 import HEAD_DIM as RWKV_HEAD_DIM
from .transformer import (BlockSpec, ModelConfig, _block_decode,
                          _block_forward, _make_block)

#: the whisper encoder's blocks
ENC_SPEC = BlockSpec(kind="attn", mlp="gelu")


class Model(Params):
    """A model of ``cfg``: parameters ``embedding``, ``final_norm`` (and
    ``enc_norm``, ``patch_proj`` where the frontend has them), ``blocks``
    and ``encoder``.  ``attention_impl`` routes prefill attention:
    ``"auto"`` runs the flash kernel wherever it takes the shape and
    autograd is not recording through it (see
    :func:`repro_torch.models.attention.prefill_route`: a training
    forward always runs the plain formulation, the kernel having no
    backward), ``"plain"`` never does.  With ``cfg.remat`` set, a forward
    that autograd records keeps no block's activations but its input and
    recomputes them in the backward pass (:meth:`_block`), the
    counterpart of the JAX package's ``jax.checkpoint`` of a layer
    group."""

    def __init__(self, cfg: ModelConfig, attention_impl: str = "auto"):
        super().__init__()
        if attention_impl not in IMPLS:
            raise ValueError(f"attention_impl must be one of {IMPLS}, not "
                             f"{attention_impl!r}")
        self.cfg = cfg
        self.pattern = cfg.pattern
        self.attention_impl = attention_impl
        make_embedding(self, cfg.vocab, cfg.d_model)
        norm_param(self, "final_norm", cfg.d_model)
        self.blocks = nn.ModuleList(
            _make_block(cfg, self.pattern[i % len(self.pattern)])
            for i in range(cfg.n_layers))
        if cfg.n_enc_layers:
            self.encoder = nn.ModuleList(_make_block(cfg, ENC_SPEC)
                                         for _ in range(cfg.n_enc_layers))
            norm_param(self, "enc_norm", cfg.d_model)
        if cfg.frontend == "vision":
            self.add("patch_proj", (cfg.d_model, cfg.d_model), "eye",
                     axes=("embed", "embed2"))

    # ---------------------------------------------------------------- #
    # weights
    # ---------------------------------------------------------------- #
    def init(self, seed: int = 0, device=None) -> Model:
        """Random weights with the JAX package's scales, made on
        ``device`` (default the card) from a generator there."""
        return init_params(self, seed, resolve(device))

    def load_jax(self, params, device=None) -> Model:
        """The JAX package's ``Model.init`` tree (nested dicts and lists of
        arrays), on ``device`` (default the card)."""
        from .convert import from_jax_params
        self.to_empty(device=resolve(device))
        self.load_state_dict(from_jax_params(self.cfg, params))
        return self

    def with_attention_impl(self, attention_impl: str) -> Model:
        """A model over the same parameters (nothing copied) whose prefill
        attention takes ``attention_impl``'s route."""
        if attention_impl not in IMPLS:
            raise ValueError(f"attention_impl must be one of {IMPLS}, not "
                             f"{attention_impl!r}")
        twin = copy.copy(self)
        twin.attention_impl = attention_impl
        return twin

    def param_axes(self) -> dict[str, tuple]:
        """Each parameter's logical axes by its ``state_dict`` name: the
        JAX package's ``model.axes`` through :mod:`.convert`'s layout (a
        layer's, the JAX stacked leaf's without its leading
        ``"layers"``)."""
        return {f"{prefix}.{name}" if prefix else name: axes
                for prefix, node in self.named_modules()
                if isinstance(node, Params)
                for name, axes in node.axes.items()}

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=dtype, device=self.device)

    # ---------------------------------------------------------------- #
    # encoder (whisper-style; frames already embedded by the stub frontend)
    # ---------------------------------------------------------------- #
    def _encode(self, frames):
        cfg = self.cfg
        frames = self._tensor(frames)
        positions = torch.arange(frames.shape[1], device=self.device)[None]
        x = frames.to(torch.bfloat16)
        for layer in self.encoder:
            x, _, _ = self._block(layer, x, ENC_SPEC, positions=positions,
                                  causal=False)
        return rms_norm(x, self["enc_norm"], cfg.norm_eps)

    def _block(self, layer, x, spec, **kwargs):
        """``_block_forward`` of one block under this model's attention
        route; where ``cfg.remat`` is set and autograd records, through
        ``torch.utils.checkpoint`` (one block a layer, the port's layer
        group), which gives the same numbers."""
        kwargs["impl"] = self.attention_impl
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(_block_forward, layer, x, self.cfg, spec,
                              use_reentrant=False, **kwargs)
        return _block_forward(layer, x, self.cfg, spec, **kwargs)

    # ---------------------------------------------------------------- #
    # full-sequence forward (training / prefill)
    # ---------------------------------------------------------------- #
    def _stack_forward(self, x, *, enc_out=None, make_cache=False,
                       kernel_config=None):
        positions = torch.arange(x.shape[1], device=x.device)[None]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        caches = []
        for i, layer in enumerate(self.blocks):
            x, c, a = self._block(
                layer, x, self.pattern[i % len(self.pattern)],
                positions=positions, enc_out=enc_out, make_cache=make_cache,
                kernel_config=kernel_config)
            caches.append(c)
            aux = aux + a
        return x, aux, (caches if make_cache else None)

    def _embed_inputs(self, batch):
        cfg = self.cfg
        tokens = self._tensor(batch["tokens"], torch.int64)
        x = embed(self["embedding"], tokens).to(torch.bfloat16)
        if cfg.frontend == "vision" and "patches" in batch:
            patches = einsum(
                "bpd,de->bpe", self._tensor(batch["patches"])
                .to(torch.bfloat16), self["patch_proj"])
            x = torch.cat([patches, x], dim=1)
        return x

    def forward(self, batch, make_cache=False, last_only=False,
                kernel_config=None):
        """Logits (B, T, vocab) in f32, the aux loss, and (caches, enc_out):
        one cache a layer with ``make_cache``.  ``batch`` holds ``tokens``
        (and ``frames`` or ``patches``), tensors or numpy arrays.
        ``kernel_config`` is offered to the flash kernel."""
        cfg = self.cfg
        enc_out = None
        if cfg.n_enc_layers:
            enc_out = self._encode(batch["frames"])
        x = self._embed_inputs(batch)
        x = constrain(x, ("pod", "data"), None, None)
        x, aux, caches = self._stack_forward(x, enc_out=enc_out,
                                             make_cache=make_cache,
                                             kernel_config=kernel_config)
        x = rms_norm(x, self["final_norm"], cfg.norm_eps)
        if cfg.frontend == "vision" and "patches" in batch:
            x = x[:, batch["patches"].shape[1]:]     # logits for text only
        if last_only:
            x = x[:, -1:]
        logits = unembed(self["embedding"], x)
        # keep the vocab axis model-sharded: the (B,S,V) tensor dominates
        # activation memory at 150k-class vocabularies
        logits = constrain(logits, ("pod", "data"), None, "model")
        return logits, aux, (caches, enc_out)

    @torch.no_grad()
    def prefill(self, batch, kernel_config=None):
        """Serving prefill: caches + last-position logits only."""
        logits, _, (caches, enc_out) = self.forward(
            batch, make_cache=True, last_only=True,
            kernel_config=kernel_config)
        return logits[:, 0], caches, enc_out

    # ---------------------------------------------------------------- #
    # losses
    # ---------------------------------------------------------------- #
    def train_loss(self, batch):
        cfg = self.cfg
        logits, aux, _ = self.forward(batch)
        labels = self._tensor(batch["labels"], torch.int64)
        mask = (labels >= 0).float()
        labels = torch.clamp(labels, min=0)
        if isinstance(logits, DTensor):
            logz, gold = _logz_and_gold(logits, labels)
        else:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        nll = (logz - gold) * mask
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = nll.sum() / denom
        zloss = cfg.z_loss_weight * ((logz * mask) ** 2).sum() / denom
        total = loss + zloss + cfg.aux_loss_weight * aux
        return total, {"nll": loss, "z_loss": zloss, "aux": aux,
                       "tokens": denom}

    # ---------------------------------------------------------------- #
    # serving
    # ---------------------------------------------------------------- #
    def init_cache(self, batch_size: int, max_len: int,
                   dtype=torch.bfloat16) -> list[dict[str, Any]]:
        """Zeroed decode caches on the model's device, one a layer.
        Windowed attn layers get ring buffers."""
        cfg = self.cfg
        dev = self.device

        def zeros(*shape, dtype=dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def one(spec: BlockSpec):
            if spec.kind == "attn":
                length = min(spec.window, max_len) if spec.window else max_len
                hkv = cfg.n_kv_heads * cfg.kv_repeat    # replicated kv heads
                return {"attn": {
                    "k": zeros(batch_size, length, hkv, cfg.d_head),
                    "v": zeros(batch_size, length, hkv, cfg.d_head)}}
            if spec.kind == "mla":
                return {"attn": {
                    "ckv": zeros(batch_size, max_len, cfg.kv_lora),
                    "k_pe": zeros(batch_size, max_len, cfg.mla_rope_dim)}}
            if spec.kind == "rwkv6":
                h = cfg.d_model // RWKV_HEAD_DIM
                return {"mixer": (
                    zeros(batch_size, h, RWKV_HEAD_DIM, RWKV_HEAD_DIM,
                          dtype=torch.float32),
                    zeros(batch_size, cfg.d_model))}
            w = cfg.rglru_width or cfg.d_model
            return {"mixer": (zeros(batch_size, w, dtype=torch.float32),
                              zeros(batch_size, CONV_WIDTH - 1, w))}

        return [one(self.pattern[i % len(self.pattern)])
                for i in range(cfg.n_layers)]

    @torch.no_grad()
    def decode_step(self, caches, token, position, *, enc_out=None):
        """``token``: (B, 1) ints; ``position`` a scalar or (B,) ints;
        returns (logits (B, vocab), caches)."""
        cfg = self.cfg
        x = embed(self["embedding"],
                  self._tensor(token, torch.int64)).to(torch.bfloat16)
        position = self._tensor(position, torch.int64)
        new = []
        for i, layer in enumerate(self.blocks):
            x, c = _block_decode(layer, x, caches[i], cfg,
                                 self.pattern[i % len(self.pattern)],
                                 position=position, enc_out=enc_out)
            new.append(c)
        x = rms_norm(x, self["final_norm"], cfg.norm_eps)
        logits = unembed(self["embedding"], x)[:, 0]
        return logits, new


def _logz_and_gold(logits, labels):
    """``logsumexp`` over the vocab and each label's logit of DTensor
    ``logits`` (B, T, V), on each rank's local shards (DTensor's own
    strategies gather the whole (B, T, V) for the backward pass): a
    vocab-sharded mesh dim gives each rank its rows' max, sum of
    exponentials and held label logits, reduced across ranks as pending
    max and sums on (B, T); batch- and sequence-sharded dims keep their
    shards."""
    mesh = logits.device_mesh
    labels = as_dtensor(labels, mesh)
    want, lab, red, mx = [], [], [], []
    for p in logits.placements:
        if p in (Shard(0), Shard(1)):
            want.append(p), lab.append(p), red.append(p), mx.append(p)
        elif p == Shard(2):
            want.append(p), lab.append(Replicate())
            red.append(Partial()), mx.append(Partial("max"))
        else:
            r = Replicate()
            want.append(r), lab.append(r), red.append(r), mx.append(r)
    lo, n = shard_span(logits.shape[2], mesh, want, 2)
    m = local_region(lambda lg: lg.detach().amax(-1), [(logits, want)], mx,
                     labels.shape)

    def sums(lg, lm, lk):
        held = (lk >= lo) & (lk < lo + n)
        g = torch.gather(lg, -1, (lk - lo).clamp(0, n - 1)[..., None])[..., 0]
        return torch.exp(lg - lm[..., None]).sum(-1), g * held.to(g.dtype)

    se, gold = local_region(
        sums, [(logits, want), (m, m.placements), (labels, lab)],
        [red, red], [labels.shape, labels.shape])
    return m + torch.log(se), gold


def build_model(cfg: ModelConfig, attention_impl: str = "auto") -> Model:
    return Model(cfg, attention_impl)
