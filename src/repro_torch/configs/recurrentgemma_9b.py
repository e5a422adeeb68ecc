"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427]"""

from ..models.transformer import BlockSpec, ModelConfig

RGLRU = BlockSpec(kind="rglru", mlp="swiglu")
LOCAL = BlockSpec(kind="attn", window=2048, mlp="swiglu")

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    vocab=256_000,
    d_model=4096,
    n_layers=38,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12_288,
    pattern=(RGLRU, RGLRU, LOCAL),     # 2 recurrent : 1 local attn
    rglru_width=4096,
    rope_theta=10_000.0,
)

TUNABLE_KERNELS = ("gemm", "flash_attention")
