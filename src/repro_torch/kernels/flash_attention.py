"""Flash attention (GQA/MQA, causal or full) as a CUDA kernel for Hopper.

Replaces the TPU kernel `repro.kernels.flash_attention._flash_kernel` (a
Pallas grid over batch, q heads, q blocks and sequential k blocks, with
the running max, sum and accumulator in VMEM scratch). `csrc/
flash_attention.cu` gives one thread block to each (batch row, q head,
64-row q tile) and walks the k tiles in it; its source note says what
bounds it and how it is laid out. The plain version is
`repro_torch.kernels.ref.mha_ref`.

`flash_attention()` takes CUDA tensors only: it checks device, dtype, shape
and contiguity and raises on anything else, allocates its outputs (o in
q's dtype and the float32 log-sum-exp the backward needs), launches on the
current stream, raises on a CUDA launch error, and adds one to
`flash_attention.launches` per launch. The library is built at first use
by `repro_torch.kernel_build` (nvcc, sm_90a) and bound with ctypes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch import kernel_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the widest head the kernel takes (zero-padded to 64, 128 or 256)
MAX_D = 256

_LAUNCH = None


def _launcher():
    """The C launch function, built and bound at first use."""
    global _LAUNCH
    if _LAUNCH is None:
        fn = kernel_build.load(SOURCE).flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel: q [B, Tq, Hq, D], k and v [B, Tk, Hkv, D],
    all float32 or all bfloat16, Hq a multiple of Hkv, D <= 256. Returns
    (o [B, Tq, Hq, D] in q's dtype, lse [B, Hq, Tq] float32)."""
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_attention: the kernel takes CUDA tensors, got "
            f"{q.device}; CPU tensors go through kernels.ops.attention's "
            f"plain version")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, T, H, D]")
    b, tq, hq, d = (int(s) for s in q.shape)
    tk, hkv = int(k.shape[1]), int(k.shape[2])
    if tuple(k.shape) != (b, tk, hkv, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be [{b}, Tk, Hkv, {d}]")
    if min(b, tq, tk, hkv, d) < 1 or hq % hkv or d > MAX_D or \
            max(b, -(-tq // 64)) >= 2 ** 16:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} outside Hq % Hkv == 0, "
                         f"1 <= D <= {MAX_D}, B and Tq / 64 below 65536")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, q is "
                             f"{q.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype}, expected "
                         f"float32 or bfloat16")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    scale = 1.0 / d ** 0.5 if scale is None else float(scale)
    launch = _launcher()
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), b, tq, tk, hq, hkv, d, scale,
                    int(bool(causal)), _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc}")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0
