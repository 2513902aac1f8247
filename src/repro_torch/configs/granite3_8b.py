"""Selectable config module (see registry.py for the definition)."""
from .registry import GRANITE_3_8B as CONFIG  # noqa: F401
