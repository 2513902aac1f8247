"""Models of the port: the dense and hybrid (RG-LRU + local attention)
decoder stacks."""
from .model import Model, build  # noqa: F401
