"""Architecture configurations of the port: the reference's ten."""
from .base import (SHAPES, ArchConfig, MLAConfig, MoEConfig,  # noqa: F401
                   ShapeSpec, input_specs, shape_applicable)
from .registry import (ARCH_IDS, DEEPSEEK_V2_LITE, GEMMA_2B,  # noqa: F401
                       GRANITE_3_8B, GROK_1_314B, INTERNVL2_26B, LLAMA32_1B,
                       MUSICGEN_LARGE, QWEN3_14B, RECURRENTGEMMA_9B,
                       XLSTM_125M, get_config, preset_config)
