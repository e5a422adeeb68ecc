"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256 — llama-arch.  [arXiv:2401.14196]"""

from ..models.transformer import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    vocab=32_256,
    d_model=7168,
    n_layers=62,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19_200,
    pattern=(BlockSpec(kind="attn", mlp="swiglu"),),
    rope_theta=100_000.0,
)

TUNABLE_KERNELS = ("gemm", "flash_attention")
