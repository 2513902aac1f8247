"""Selectable config module (see registry.py for the definition)."""
from .registry import QWEN3_14B as CONFIG  # noqa: F401
