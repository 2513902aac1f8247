"""Selectable config module (see registry.py for the definition)."""
from .registry import DEEPSEEK_V2_LITE as CONFIG  # noqa: F401
