"""qwen3-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B]"""

from ..models.transformer import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    vocab=151_936,
    d_model=4096,
    n_layers=36,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12_288,
    pattern=(BlockSpec(kind="attn", mlp="swiglu"),),
    qk_norm=True,
    rope_theta=1_000_000.0,
)

#: kernels whose tuned configs this arch consumes (paper-technique hookup)
TUNABLE_KERNELS = ("gemm", "flash_attention")
