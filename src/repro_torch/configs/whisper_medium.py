"""whisper-medium [audio]: 24L enc + 24L dec, d_model=1024 16H (kv=16)
d_ff=4096 vocab=51865 — enc-dec; the conv frontend is a STUB (precomputed
frame embeddings per the assignment).  [arXiv:2212.04356]

Shape-cell semantics for enc-dec (see DESIGN.md §5): seq_len applies to the
*encoder frames*; the decoder runs its architectural length.  decode cells
mechanically extend the decoder self-attention cache as assigned.
"""

from ..models.transformer import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    vocab=51_865,
    d_model=1024,
    n_layers=24,                  # decoder layers
    n_enc_layers=24,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    pattern=(BlockSpec(kind="attn", mlp="gelu", cross=True),),
    frontend="audio",
    rope_theta=10_000.0,
)

TUNABLE_KERNELS = ("gemm", "flash_attention", "conv2d")
