"""The RG-LRU recurrence as a CUDA kernel for Hopper.

Replaces the TPU kernel `repro.kernels.rglru._rglru_kernel` (a Pallas grid
over batch, feature blocks and sequential time blocks with h in VMEM
scratch). `csrc/rglru.cu` gives one thread to each (b, d) channel, walking
T with h in a register; its source note says what bounds it and why it is
shaped so. The plain version is `repro_torch.kernels.ref.rglru_ref`.

`rglru()` takes CUDA tensors only: it checks device, dtype, shape and
contiguity and raises on anything else, allocates its outputs, launches on
the current stream, raises on a CUDA launch error, and adds one to
`rglru.launches` per launch. The library is built at first use by
`repro_torch.kernel_build` (nvcc, sm_90a) and bound with ctypes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch import kernel_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LAUNCH = None


def _launcher():
    """The C launch function, built and bound at first use."""
    global _LAUNCH
    if _LAUNCH is None:
        fn = kernel_build.load(SOURCE).rglru_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"rglru: {name} on {t.device}, x on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"rglru: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"rglru: {name} is {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"rglru: {name} must be contiguous")


def rglru(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
          log_lambda: torch.Tensor, h0: Optional[torch.Tensor] = None,
          c: float = 8.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel: x, r, i [B, T, D] in float32 or bfloat16,
    log_lambda float32 [D], h0 float32 [B, D] or None. Returns (y [B, T, D]
    in x's dtype, h_T float32 [B, D])."""
    if x.device.type != "cuda":
        raise ValueError(
            f"rglru: the kernel takes CUDA tensors, got {x.device}; CPU "
            f"tensors go through kernels.ops.rglru_scan's plain version")
    if x.dim() != 3 or x.dtype not in _DTYPES:
        raise ValueError(f"rglru: x must be [B, T, D] float32 or bfloat16, "
                         f"got {tuple(x.shape)} {x.dtype}")
    b, t, d = (int(s) for s in x.shape)
    if min(b, t, d) < 1 or b * d >= 2 ** 31:
        raise ValueError(f"rglru: empty or oversized shape {(b, t, d)}")
    for name, ten in (("x", x), ("r", r), ("i", i)):
        _check(name, ten, (b, t, d), x.dtype, x.device)
    _check("log_lambda", log_lambda, (d,), torch.float32, x.device)
    if h0 is not None:
        _check("h0", h0, (b, d), torch.float32, x.device)
    launch = _launcher()
    y = torch.empty_like(x)
    h_out = torch.empty((b, d), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = launch(
            x.data_ptr(), r.data_ptr(), i.data_ptr(), log_lambda.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_out.data_ptr(), b, t, d, _DTYPES[x.dtype], float(c), stream)
    if rc != 0:
        raise RuntimeError(f"rglru kernel launch failed: cudaError {rc}")
    rglru.launches += 1
    return y, h_out


rglru.launches = 0
