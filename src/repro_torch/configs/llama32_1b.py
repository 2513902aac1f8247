"""Selectable config module (see registry.py for the definition)."""
from .registry import LLAMA32_1B as CONFIG  # noqa: F401
