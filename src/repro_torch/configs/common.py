"""Config utilities: reduced (smoke-test) configs and the shape cells."""

from __future__ import annotations

import dataclasses

from ..models.transformer import ModelConfig

# ------------------------------------------------------------------ #
# assigned input-shape cells (LM transformer shapes)
# ------------------------------------------------------------------ #
SHAPES = {
    "train_4k": {"seq_len": 4096, "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32_768, "global_batch": 32, "kind": "prefill"},
    "decode_32k": {"seq_len": 32_768, "global_batch": 128, "kind": "decode"},
    "long_500k": {"seq_len": 524_288, "global_batch": 1, "kind": "decode"},
}

#: archs that run the long_500k cell (sub-quadratic context handling);
#: pure full-attention archs skip it (see DESIGN.md §5)
LONG_CONTEXT_ARCHS = ("rwkv6-1.6b", "recurrentgemma-9b", "gemma3-27b")


def cells_for(arch_name: str):
    for shape_name in SHAPES:
        if shape_name == "long_500k" and arch_name not in LONG_CONTEXT_ARCHS:
            continue
        yield shape_name


def attention_shape(cfg: ModelConfig, seq_len: int) -> dict:
    """The flash-attention problem shape a model dispatches at ``seq_len``
    — the find-DB lookup key tying the model zoo to the tuning campaigns
    (``AttentionProblem`` shape kwargs: query/kv head counts, query and
    kv sequence lengths, head dim)."""
    return {"hq": cfg.n_heads, "hkv": max(1, cfg.n_kv_heads),
            "tq": int(seq_len), "tk": int(seq_len), "d": cfg.d_head}


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests: same pattern/features,
    small dims."""
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, 2))
    if cfg.n_heads % n_kv:
        n_kv = 1
    d_head = 16
    d_model = 64 if "rwkv" not in cfg.name else 128   # rwkv head dim is 64
    if any(s.kind == "rwkv6" for s in cfg.pattern):
        d_model = 128
    pattern = tuple(dataclasses.replace(
        s, window=min(s.window, 32) if s.window else None)
        for s in cfg.pattern)
    return dataclasses.replace(
        cfg,
        n_layers=max(len(cfg.pattern), min(cfg.n_layers,
                                           2 * len(cfg.pattern))) + 1,
        d_model=d_model,
        n_heads=d_model // d_head,
        n_kv_heads=n_kv if (d_model // d_head) % n_kv == 0 else 1,
        d_ff=4 * d_model,
        vocab=512,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2),
        n_shared=min(cfg.n_shared, 1),
        d_ff_expert=2 * d_model if cfg.n_experts else 0,
        moe_group=16,
        kv_lora=32, q_lora=48, nope_dim=d_head, mla_rope_dim=8,
        rglru_width=d_model if cfg.rglru_width else 0,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        n_patches=4,
        pattern=pattern,
        remat=False,
    )
