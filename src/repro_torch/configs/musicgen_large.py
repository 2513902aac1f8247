"""Selectable config module (see registry.py for the definition)."""
from .registry import MUSICGEN_LARGE as CONFIG  # noqa: F401
