"""Models of the port: the dense decoder stack."""
from .model import Model, build  # noqa: F401
