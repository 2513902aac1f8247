"""Flash attention (GQA/MQA, causal or full) as CUDA kernels for Hopper.

Replaces the TPU kernel `repro.kernels.flash_attention._flash_kernel` (a
Pallas grid over batch, q heads, q blocks and sequential k blocks, with
the running max, sum and accumulator in VMEM scratch). Two kernels compute
that function, and `route` picks one by a stated rule:

  sm90 — `csrc/flash_attention_sm90.cu`: bfloat16 tiles loaded by TMA,
         both products on the tensor cores (wgmma), for every bfloat16
         call that TMA can address;
  simt — `csrc/flash_attention.cu`: float32 tiles and FMA dot products,
         for float32 and every other bfloat16 call.

Each gives one thread block to each (batch row, q head, 64-row q tile) and
walks the k tiles in it; its source note says what bounds it and how it is
laid out. The plain version is `repro_torch.kernels.ref.mha_ref`.

`flash_attention()` takes CUDA tensors only: it checks device, dtype, shape
and contiguity and raises on anything else, allocates its outputs (o in
q's dtype and the float32 log-sum-exp the backward needs), launches on the
current stream and raises on a CUDA launch error. Each kernel's wrapper
(`flash_attention_sm90`, `flash_attention_simt`) counts its own launches
where it launches; `launches()` is their sum. The libraries are built
at first use by `repro_torch.kernel_build` (nvcc, sm_90a) and bound with
ctypes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch import kernel_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
SOURCE_SM90 = Path(__file__).resolve().parent / "csrc" / "flash_attention_sm90.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the widest head the kernels take (zero-padded to 64, 128 or 256)
MAX_D = 256

_LAUNCH = {}


def _launcher(source: Path):
    """A kernel's C launch function, built and bound at first use."""
    fn = _LAUNCH.get(source)
    if fn is None:
        lib = kernel_build.load(source)
        sm90 = source == SOURCE_SM90
        fn = lib.flash_attention_sm90_launch if sm90 else \
            lib.flash_attention_launch
        # q, k, v, o, lse; b, tq, tk, hq, hkv, d; scale; causal; (the SIMT
        # kernel's dtype); stream
        dtype = [] if sm90 else [ctypes.c_int]
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int] + dtype + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH[source] = fn
    return fn


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which kernel takes (q, k, v): "sm90" or "simt". A pure function of
    dtype, shape, strides and alignment, on any device. "sm90" takes
    bfloat16 q, k and v that TMA can address as [B, T, H, D] maps:
    contiguous, D a multiple of 8 and at most 256 (so every stride, the
    head's included, is a multiple of 16 bytes) and 16-byte-aligned data.
    Everything else, float32 included, goes to "simt"."""
    d = int(q.shape[-1])
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)) or d % 8 or \
            d > MAX_D:
        return "simt"
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in (q, k, v)):
        return "simt"
    return "sm90"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Raise on what neither kernel takes; return (B, Tq, Tk, Hq, Hkv, D)."""
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
    return b, tq, tk, hq, hkv, d


def _launch(source: Path, extra: tuple, dims, q, k, v, causal, scale):
    """Launch `source`'s kernel on inputs `_check` passed (`dims` is what
    it returned); `extra` is the SIMT kernel's dtype, or nothing."""
    b, tq, tk, hq, hkv, d = dims
    scale = 1.0 / d ** 0.5 if scale is None else float(scale)
    launch = _launcher(source)
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), b, tq, tk, hq, hkv, d, scale,
                    int(bool(causal)), *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{source.name} kernel launch failed: error {rc} "
                           f"(below 1000 a cudaError; 1001 no tensor-map "
                           f"encoder, 1002 a tensor map refused)")
    return o, lse


def flash_attention_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the SIMT kernel (float32 or bfloat16)."""
    dims = _check(q, k, v)
    out = _launch(SOURCE, (_DTYPES[q.dtype],), dims, q, k, v, causal, scale)
    flash_attention_simt.launches += 1
    return out


def flash_attention_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the wgmma/TMA kernel: bfloat16 inputs that `route`
    sends to "sm90" only (raises on others)."""
    dims = _check(q, k, v)
    if route(q, k, v) != "sm90":
        raise ValueError(f"flash_attention_sm90: takes bfloat16, contiguous, "
                         f"16-byte-aligned q, k, v with D % 8 == 0; got "
                         f"{q.dtype}, D {q.shape[-1]}")
    out = _launch(SOURCE_SM90, (), dims, q, k, v, causal, scale)
    flash_attention_sm90.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel `route` picks: q [B, Tq, Hq, D], k and v
    [B, Tk, Hkv, D], all float32 or all bfloat16, Hq a multiple of Hkv,
    D <= 256. Returns (o [B, Tq, Hq, D] in q's dtype, lse [B, Hq, Tq]
    float32)."""
    kernel = (flash_attention_sm90 if route(q, k, v) == "sm90"
              else flash_attention_simt)
    return kernel(q, k, v, causal=causal, scale=scale)


def launches() -> int:
    """Launches of both kernels so far (each wrapper counts its own)."""
    return flash_attention_sm90.launches + flash_attention_simt.launches


flash_attention_simt.launches = 0
flash_attention_sm90.launches = 0
