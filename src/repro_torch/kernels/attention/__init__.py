from .ops import attention
from .ref import mha_reference
from .space import AttentionProblem

#: the public attention op under the JAX package's name
flash_attention = attention

__all__ = ["flash_attention", "mha_reference", "attention", "AttentionProblem"]
