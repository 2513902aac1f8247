"""Synthetic data of the port."""
from .pipeline import DataConfig, iterator, synthetic_batch  # noqa: F401
