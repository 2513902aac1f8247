"""Puts the repository root (for `portbench`) and `src` (for the port) on
the path of this folder's tests."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src"), str(Path(__file__).parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
