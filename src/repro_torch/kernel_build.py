"""Build the port's CUDA sources into shared libraries and load them.

Every kernel of the port is a CUDA C++ file under a `csrc/` directory with
a plain C launch function (`extern "C"`), compiled with
`nvcc -gencode arch=compute_90a,code=sm_90a` into
`build/repro_torch_kernels/` at the repository root and bound with ctypes
(no PyTorch headers, so a build takes seconds). A library's name hashes
its source and the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. `compile_all` starts one nvcc per source, all at
once; `load` compiles one source if needed and opens it once per process.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: source stem -> the compiler's output of its last build in this process
BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[Path, ctypes.CDLL] = {}
_LOCK = threading.RLock()


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"


def compile_all(sources: Sequence[Path]) -> Dict[str, float]:
    """Compile every source not built yet, one nvcc process each, started
    together. Returns seconds per source stem (0.0 where a build existed).
    Raises with the compiler's output when any nvcc fails."""
    with _LOCK:
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        started = {}
        seconds = {}
        for src in sources:
            path = library_path(src)
            if path.exists():
                seconds[src.stem] = 0.0
                continue
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            started[src] = (proc, tmp, path, time.perf_counter())
        failed = []
        for src, (proc, tmp, path, t0) in started.items():
            out, _ = proc.communicate()
            seconds[src.stem] = time.perf_counter() - t0
            BUILD_LOG[src.stem] = out
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) on {src}:\n{out}")
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("\n".join(failed))
        return seconds


def load(source: Path) -> ctypes.CDLL:
    """The library built from `source`: compiled first if needed, opened
    once per process."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            compile_all([source])
            lib = _LIBS[source] = ctypes.CDLL(str(library_path(source)))
        return lib
