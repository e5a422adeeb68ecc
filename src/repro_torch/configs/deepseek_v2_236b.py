"""deepseek-v2-236b [moe]: 60L d_model=5120 128H (MLA kv_lora=512)
d_ff=1536/expert vocab=102400, MoE 2 shared + 160 routed top-6.
[arXiv:2405.04434]"""

from ..models.transformer import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    vocab=102_400,
    d_model=5120,
    n_layers=60,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12_288,                  # (dense d_ff unused; experts carry the ff)
    pattern=(BlockSpec(kind="mla", mlp="moe"),),
    n_experts=160,
    top_k=6,
    n_shared=2,
    d_ff_expert=1536,
    capacity_factor=1.25,
    moe_group=128,
    kv_lora=512,
    q_lora=1536,
    nope_dim=128,
    mla_rope_dim=64,
    rope_theta=10_000.0,
)

TUNABLE_KERNELS = ("gemm", "flash_attention")
