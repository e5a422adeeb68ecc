"""qwen3-14b [dense]: 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B family]"""

from ..models.transformer import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    vocab=151_936,
    d_model=5120,
    n_layers=40,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17_408,
    pattern=(BlockSpec(kind="attn", mlp="swiglu"),),
    qk_norm=True,
    rope_theta=1_000_000.0,
)

TUNABLE_KERNELS = ("gemm", "flash_attention")
