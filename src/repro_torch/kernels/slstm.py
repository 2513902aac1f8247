"""The sLSTM recurrence as a CUDA kernel for Hopper.

Replaces the TPU kernel `repro.kernels.slstm._slstm_kernel` (a Pallas grid
over batch blocks and sequential time steps with R held in VMEM and the
state in VMEM scratch). `csrc/slstm.cu` gives one thread block to each
batch row, walking T with h in shared memory and c, n, m in registers; its
source note says what bounds it and why it is shaped so. The plain version
is `repro_torch.kernels.ref.slstm_ref`.

`slstm()` takes CUDA tensors only: it checks device, dtype, shape and
contiguity and raises on anything else, allocates its outputs, launches on
the current stream, raises on a CUDA launch error, and adds one to
`slstm.launches` per launch. The library is built at first use by
`repro_torch.kernel_build` (nvcc, sm_90a) and bound with ctypes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch import kernel_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "slstm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the widest D the kernel takes (8 channels per thread, 1024 threads)
MAX_D = 8192

_LAUNCH = None


def _launcher():
    """The C launch function, built and bound at first use."""
    global _LAUNCH
    if _LAUNCH is None:
        fn = kernel_build.load(SOURCE).slstm_launch
        fn.argtypes = [ctypes.c_void_p] * 12 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def _check(name: str, t: torch.Tensor, shape, dtypes, device) -> None:
    if t.device != device:
        raise ValueError(f"slstm: {name} on {t.device}, wx on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"slstm: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"slstm: {name} is {t.dtype}, expected one of "
                         f"{dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"slstm: {name} must be contiguous")


def slstm(wx: torch.Tensor, r_gates: torch.Tensor, b_gates: torch.Tensor,
          h0: torch.Tensor, c0: torch.Tensor, n0: torch.Tensor,
          m0: torch.Tensor) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One launch of the kernel: wx [B, T, 4, D] in float32 or bfloat16,
    r_gates [D, 4, D] and b_gates [4, D] both float32 or both bfloat16,
    h0, c0, n0, m0 float32 [B, D]. Returns (y [B, T, D] in wx's dtype,
    (h, c, n, m) float32 [B, D])."""
    if wx.device.type != "cuda":
        raise ValueError(
            f"slstm: the kernel takes CUDA tensors, got {wx.device}; CPU "
            f"tensors go through kernels.ops.slstm_scan's plain version")
    if wx.dim() != 4 or wx.shape[2] != 4 or wx.dtype not in _DTYPES:
        raise ValueError(f"slstm: wx must be [B, T, 4, D] float32 or "
                         f"bfloat16, got {tuple(wx.shape)} {wx.dtype}")
    b, t, _, d = (int(s) for s in wx.shape)
    if min(b, t, d) < 1 or d > MAX_D or b >= 2 ** 31:
        raise ValueError(f"slstm: shape {(b, t, 4, d)} outside B, T >= 1, "
                         f"1 <= D <= {MAX_D}")
    _check("wx", wx, (b, t, 4, d), (wx.dtype,), wx.device)
    _check("r_gates", r_gates, (d, 4, d), tuple(_DTYPES), wx.device)
    _check("b_gates", b_gates, (4, d), (r_gates.dtype,), wx.device)
    for name, s in (("h0", h0), ("c0", c0), ("n0", n0), ("m0", m0)):
        _check(name, s, (b, d), (torch.float32,), wx.device)
    launch = _launcher()
    y = torch.empty((b, t, d), dtype=wx.dtype, device=wx.device)
    h, c, n, m = (torch.empty((b, d), dtype=torch.float32, device=wx.device)
                  for _ in range(4))
    stream = torch.cuda.current_stream(wx.device).cuda_stream
    with torch.cuda.device(wx.device):
        rc = launch(
            wx.data_ptr(), r_gates.data_ptr(), b_gates.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), n0.data_ptr(), m0.data_ptr(),
            y.data_ptr(), h.data_ptr(), c.data_ptr(), n.data_ptr(),
            m.data_ptr(), b, t, d, _DTYPES[wx.dtype], _DTYPES[r_gates.dtype],
            stream)
    if rc != 0:
        raise RuntimeError(f"slstm kernel launch failed: cudaError {rc}")
    slstm.launches += 1
    return y, (h, c, n, m)


slstm.launches = 0
