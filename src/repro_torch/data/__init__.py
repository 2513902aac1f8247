"""Synthetic data of the port."""
from .pipeline import (DataConfig, embed_stub_batch, iterator,  # noqa: F401
                       sharded_batch,
                       synthetic_batch)
