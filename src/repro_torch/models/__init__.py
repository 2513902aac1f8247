"""Models of the port: the dense, hybrid (RG-LRU + local attention) and
xLSTM (mLSTM + sLSTM) decoder stacks."""
from .model import Model, build  # noqa: F401
