"""Optimizer and gradient compression of the port."""
from .adamw import (AdamWConfig, clip_by_global_norm,  # noqa: F401
                    cosine_schedule, global_norm, init, update)
from . import compression  # noqa: F401
