"""The LM stack as PyTorch modules: the port of ``repro.models``."""

from .model import Model, build_model
from .transformer import BlockSpec, ModelConfig

__all__ = ["Model", "build_model", "ModelConfig", "BlockSpec"]
