"""Optimizer and gradient compression of the port."""
from .adamw import AdamWConfig, cosine_schedule  # noqa: F401
from . import compression  # noqa: F401
