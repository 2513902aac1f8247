"""Selectable config module (see registry.py for the definition)."""
from .registry import GEMMA_2B as CONFIG  # noqa: F401
