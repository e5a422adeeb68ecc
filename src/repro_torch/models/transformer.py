"""Model assembly: blocks of a heterogeneous transformer stack.

The port of ``repro.models.transformer``.  A model is a repeating
``pattern`` of blocks (e.g. gemma3's 5 local + 1 global, recurrentgemma's
rglru/rglru/local-attn); layer i is ``pattern[i % len(pattern)]``.

Block kinds: "attn" (GQA; window optional), "mla", "rwkv6", "rglru".
MLP kinds: "swiglu", "gelu", "relu2", "moe".
Encoder-decoder (whisper) and vision-prefix (internvl2) variants supported
via config.frontend.  :class:`BlockSpec` and :class:`ModelConfig` are the
JAX package's, copied as data.
"""

from __future__ import annotations

import dataclasses

import torch

from . import attention as attn
from . import moe as moe_lib
from . import rglru as rglru_lib
from . import rwkv6 as rwkv_lib
from .layers import Params, make_mlp, mlp, norm_param, rms_norm


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    kind: str = "attn"            # attn | mla | rwkv6 | rglru
    window: int | None = None     # sliding window (attn only)
    mlp: str = "swiglu"           # swiglu | gelu | moe
    cross: bool = False           # add cross-attention (enc-dec decoder)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    vocab: int = 32_000
    d_model: int = 1024
    n_layers: int = 8
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 4096
    pattern: tuple[BlockSpec, ...] = (BlockSpec(),)
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    # MoE
    n_experts: int = 0
    top_k: int = 2
    n_shared: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 128
    # MLA
    kv_lora: int = 512
    q_lora: int = 1536
    nope_dim: int = 128
    mla_rope_dim: int = 64
    # recurrent
    rglru_width: int = 0
    # frontend / enc-dec
    frontend: str | None = None      # None | "audio" | "vision"
    n_enc_layers: int = 0
    n_patches: int = 256
    # training
    remat: bool = True
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 1e-4
    # beyond-paper SPMD optimizations (default OFF = paper-faithful baseline;
    # the planner flips these per mesh — see launch/steps.plan_cell and
    # EXPERIMENTS.md §Perf for the before/after)
    opt_attn: bool = False        # explicit attention sharding + kv replication
    # the JAX package's divisibility-aware MoE dispatch sharding: kept so
    # both packages' configs have the same fields, read nowhere here (the
    # MoE region reads the experts' split off their placements, which
    # never put ``model`` on an expert axis it does not divide)
    opt_moe: bool = False
    opt_scatter_cache: bool = False  # decode caches: scatter, not onehot blend
    kv_repeat: int = 1            # kv-head replication factor (set by planner)

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic total parameter count (for 6ND roofline bookkeeping)."""
        d, v = self.d_model, self.vocab
        n = v * d                                    # embedding (tied)
        per_kind = {}
        for spec in set(self.pattern):
            c = 0
            if spec.kind == "attn":
                c += d * (self.n_heads + 2 * self.n_kv_heads
                          + self.n_heads) * self.d_head
            elif spec.kind == "mla":
                c += (d * self.q_lora
                      + self.q_lora * self.n_heads * (self.nope_dim
                                                      + self.mla_rope_dim)
                      + d * self.kv_lora + d * self.mla_rope_dim
                      + self.kv_lora * self.n_heads * (self.nope_dim + 128)
                      + self.n_heads * 128 * d)
            elif spec.kind == "rwkv6":
                c += 6 * d * d
            elif spec.kind == "rglru":
                w = self.rglru_width or d
                c += 2 * d * w + 2 * w * w + 2 * w * d
            if spec.cross:
                c += d * (self.n_heads + 2 * self.n_kv_heads
                          + self.n_heads) * self.d_head
            if spec.mlp == "moe":
                c += (d * self.n_experts
                      + 3 * self.n_experts * d * self.d_ff_expert
                      + (3 * d * self.n_shared * self.d_ff_expert
                         if self.n_shared else 0))
            elif spec.mlp == "gelu":
                c += 2 * d * self.d_ff
            else:
                c += 3 * d * self.d_ff
            per_kind[spec] = c
        # decoder layers follow the pattern cyclically
        total_layers = self.n_layers + self.n_enc_layers
        for i in range(self.n_layers):
            n += per_kind[self.pattern[i % len(self.pattern)]]
        if self.n_enc_layers:
            enc_spec = BlockSpec(kind="attn", mlp="gelu")
            enc_c = (d * (self.n_heads + 2 * self.n_kv_heads + self.n_heads)
                     * self.d_head + 2 * d * self.d_ff)
            n += self.n_enc_layers * enc_c
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        for i in range(self.n_layers):
            spec = self.pattern[i % len(self.pattern)]
            if spec.mlp == "moe":
                inactive = 3 * (self.n_experts - self.top_k) \
                    * self.d_model * self.d_ff_expert
                full -= inactive
        return full


# ------------------------------------------------------------------ #
# block construction
# ------------------------------------------------------------------ #
def _make_block(cfg: ModelConfig, spec: BlockSpec) -> Params:
    p = Params()
    norm_param(p, "ln1", cfg.d_model)
    if spec.kind == "attn":
        p.attn = attn.make_gqa(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.d_head, qk_norm=cfg.qk_norm)
    elif spec.kind == "mla":
        p.attn = attn.make_mla(cfg.d_model, cfg.n_heads, kv_lora=cfg.kv_lora,
                               q_lora=cfg.q_lora, nope_dim=cfg.nope_dim,
                               rope_dim=cfg.mla_rope_dim)
    elif spec.kind == "rwkv6":
        p.mixer = rwkv_lib.make_rwkv6(cfg.d_model)
    elif spec.kind == "rglru":
        p.mixer = rglru_lib.make_rglru(cfg.d_model,
                                       cfg.rglru_width or cfg.d_model)
    if spec.cross:
        norm_param(p, "ln_x", cfg.d_model)
        p.xattn = attn.make_gqa(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.d_head)
    norm_param(p, "ln2", cfg.d_model)
    if spec.mlp == "moe":
        p.moe = moe_lib.make_moe(cfg.d_model, cfg.d_ff_expert, cfg.n_experts,
                                 n_shared=cfg.n_shared)
    else:
        p.mlp = make_mlp(cfg.d_model, cfg.d_ff, spec.mlp)
    return p


def _block_forward(p, x, cfg: ModelConfig, spec: BlockSpec, *, positions,
                   enc_out=None, causal=True, make_cache=False,
                   impl="auto", kernel_config=None):
    """One block over the full sequence: (x, cache, aux loss).  ``impl`` and
    ``kernel_config`` go to :func:`attn.gqa_forward`'s self-attention."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    cache = {}
    if spec.kind == "attn":
        o, c = attn.gqa_forward(p["attn"], h, positions=positions,
                                window=spec.window, causal=causal,
                                qk_norm=cfg.qk_norm,
                                rope_theta=cfg.rope_theta,
                                make_cache=make_cache,
                                opt=cfg.opt_attn, kv_repeat=cfg.kv_repeat,
                                impl=impl, kernel_config=kernel_config)
        cache["attn"] = c
    elif spec.kind == "mla":
        o, c = attn.mla_forward(p["attn"], h, positions=positions,
                                rope_theta=cfg.rope_theta,
                                make_cache=make_cache)
        cache["attn"] = c
    elif spec.kind == "rwkv6":
        o, c = rwkv_lib.rwkv6_forward(p["mixer"], h, make_cache=make_cache)
        cache["mixer"] = c
    else:
        o, c = rglru_lib.rglru_forward(p["mixer"], h, make_cache=make_cache)
        cache["mixer"] = c
    x = x + o
    if spec.cross:
        hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
        ox, _ = attn.gqa_forward(p["xattn"], hx, positions=positions,
                                 causal=False, kv_override=enc_out,
                                 rope_theta=0.0, make_cache=False)
        x = x + ox
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.mlp == "moe":
        o2, metrics = moe_lib.moe_ffn(p["moe"], h2, top_k=cfg.top_k,
                                      capacity_factor=cfg.capacity_factor,
                                      group_size=cfg.moe_group)
        aux = metrics["aux_loss"]
    else:
        o2 = mlp(p["mlp"], h2, spec.mlp)
    return x + o2, cache, aux


def _block_decode(p, x, cache, cfg: ModelConfig, spec: BlockSpec, *,
                  position, enc_out=None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.kind == "attn":
        cache_len = cache["attn"]["k"].shape[1]
        # windowed layers use a ring buffer (cache_len == window)
        ins = position % cache_len if spec.window else None
        o, c = attn.gqa_decode(p["attn"], h, cache["attn"],
                               position=position, insert_at=ins,
                               qk_norm=cfg.qk_norm,
                               rope_theta=cfg.rope_theta,
                               opt=cfg.opt_attn, kv_repeat=cfg.kv_repeat,
                               scatter=cfg.opt_scatter_cache)
        cache = dict(cache, attn=c)
    elif spec.kind == "mla":
        o, c = attn.mla_decode(p["attn"], h, cache["attn"],
                               position=position, rope_theta=cfg.rope_theta,
                               scatter=cfg.opt_scatter_cache)
        cache = dict(cache, attn=c)
    elif spec.kind == "rwkv6":
        o, c = rwkv_lib.rwkv6_decode(p["mixer"], h, cache["mixer"])
        cache = dict(cache, mixer=c)
    else:
        o, c = rglru_lib.rglru_decode(p["mixer"], h, cache["mixer"])
        cache = dict(cache, mixer=c)
    x = x + o
    if spec.cross:
        hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
        ox, _ = attn.gqa_forward(
            p["xattn"], hx,
            positions=torch.zeros((1, 1), dtype=torch.int64,
                                  device=x.device),
            causal=False, kv_override=enc_out, rope_theta=0.0,
            make_cache=False)
        x = x + ox
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if spec.mlp == "moe":
        o2, _ = moe_lib.moe_ffn(p["moe"], h2, top_k=cfg.top_k,
                                capacity_factor=max(cfg.capacity_factor, 2.0),
                                group_size=min(cfg.moe_group, x.shape[0]))
        # decode groups are tiny; higher capacity avoids drops
    else:
        o2 = mlp(p["mlp"], h2, spec.mlp)
    return x + o2, cache
