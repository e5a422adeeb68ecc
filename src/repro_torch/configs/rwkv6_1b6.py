"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168 vocab=65536
— Finch: data-dependent decay, token shift.  [arXiv:2404.05892]"""

from ..models.transformer import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    vocab=65_536,
    d_model=2048,
    n_layers=24,
    n_heads=32,                   # d_model / rwkv head dim (64)
    n_kv_heads=32,
    d_ff=7168,
    pattern=(BlockSpec(kind="rwkv6", mlp="relu2"),),
    rope_theta=0.0,
)

TUNABLE_KERNELS = ("gemm",)       # recurrence-bound: attention kernel n/a
