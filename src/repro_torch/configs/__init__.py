"""Architecture configurations of the port."""
from .base import ArchConfig, MLAConfig, MoEConfig  # noqa: F401
from .registry import (ARCH_IDS, GEMMA_2B, RECURRENTGEMMA_9B,  # noqa: F401
                       XLSTM_125M, get_config, preset_config)
