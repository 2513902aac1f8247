"""Selectable config module (see registry.py for the definition)."""
from .registry import XLSTM_125M as CONFIG  # noqa: F401
