"""Models of the port: the decoder stacks of every registry family (dense
and MoE attention with GQA or MLA, embed stub, the hybrid RG-LRU + local
attention, xLSTM)."""
from .model import Model, build  # noqa: F401
