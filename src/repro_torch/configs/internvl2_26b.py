"""Selectable config module (see registry.py for the definition)."""
from .registry import INTERNVL2_26B as CONFIG  # noqa: F401
