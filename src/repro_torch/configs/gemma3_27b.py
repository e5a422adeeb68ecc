"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global interleave, 128k context.
[hf:google/gemma-3 family]"""

from ..models.transformer import BlockSpec, ModelConfig

LOCAL = BlockSpec(kind="attn", window=1024, mlp="swiglu")
GLOBAL = BlockSpec(kind="attn", window=None, mlp="swiglu")

CONFIG = ModelConfig(
    name="gemma3-27b",
    vocab=262_144,
    d_model=5376,
    n_layers=62,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21_504,
    pattern=(LOCAL, LOCAL, LOCAL, LOCAL, LOCAL, GLOBAL),   # 5:1
    rope_theta=1_000_000.0,
)

TUNABLE_KERNELS = ("gemm", "flash_attention")
