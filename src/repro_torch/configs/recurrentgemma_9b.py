"""Selectable config module (see registry.py for the definition)."""
from .registry import RECURRENTGEMMA_9B as CONFIG  # noqa: F401
