"""Architecture registry: ``--arch <id>`` resolves here."""

from . import (deepseek_coder_33b, deepseek_v2_236b, gemma3_27b,
               granite_moe_3b, internvl2_26b, qwen3_14b, qwen3_8b,
               recurrentgemma_9b, rwkv6_1b6, whisper_medium)
from .common import LONG_CONTEXT_ARCHS, SHAPES, cells_for, reduce_config

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (whisper_medium, rwkv6_1b6, deepseek_v2_236b, granite_moe_3b,
              internvl2_26b, qwen3_14b, gemma3_27b, qwen3_8b,
              deepseek_coder_33b, recurrentgemma_9b)
}

TUNABLE_KERNELS = {
    m.CONFIG.name: m.TUNABLE_KERNELS
    for m in (whisper_medium, rwkv6_1b6, deepseek_v2_236b, granite_moe_3b,
              internvl2_26b, qwen3_14b, gemma3_27b, qwen3_8b,
              deepseek_coder_33b, recurrentgemma_9b)
}

__all__ = ["ARCHS", "TUNABLE_KERNELS", "SHAPES", "LONG_CONTEXT_ARCHS",
           "cells_for", "reduce_config"]
