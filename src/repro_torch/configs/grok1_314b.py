"""Selectable config module (see registry.py for the definition)."""
from .registry import GROK_1_314B as CONFIG  # noqa: F401
