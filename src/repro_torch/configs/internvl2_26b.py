"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT frontend is a STUB (precomputed patch embeddings per
the assignment); the LM backbone is fully modeled.  [arXiv:2404.16821]"""

from ..models.transformer import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    vocab=92_553,
    d_model=6144,
    n_layers=48,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16_384,
    pattern=(BlockSpec(kind="attn", mlp="swiglu"),),
    frontend="vision",
    n_patches=256,
    rope_theta=10_000.0,
)

TUNABLE_KERNELS = ("gemm", "flash_attention")
