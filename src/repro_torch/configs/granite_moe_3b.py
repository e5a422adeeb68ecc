"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512/expert
vocab=49155, MoE 40e top-8.  [hf:ibm-granite]"""

from ..models.transformer import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    vocab=49_155,
    d_model=1536,
    n_layers=32,
    n_heads=24,
    n_kv_heads=8,
    d_ff=4096,
    pattern=(BlockSpec(kind="attn", mlp="moe"),),
    n_experts=40,
    top_k=8,
    n_shared=0,
    d_ff_expert=512,
    capacity_factor=1.25,
    moe_group=128,
    rope_theta=10_000.0,
)

TUNABLE_KERNELS = ("gemm", "flash_attention")
