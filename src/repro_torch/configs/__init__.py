"""Architecture config registry: one module per assigned architecture."""
from . import base
from .base import ArchConfig, SHAPES, all_configs, get_config, reduced, shape_applicable

from . import (  # noqa: F401  — importing registers each config
    qwen2_vl_72b, smollm_135m, command_r_35b, qwen3_32b, qwen2_1_5b,
    deepseek_v3_671b, deepseek_v2_236b, whisper_large_v3, xlstm_1_3b,
    zamba2_2_7b,
)

ALL_ARCHS = tuple(sorted(base._REGISTRY))
