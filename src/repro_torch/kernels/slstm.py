"""The sLSTM recurrence as CUDA kernels for Hopper.

Replaces the TPU kernel `repro.kernels.slstm._slstm_kernel` (a Pallas grid
over batch blocks and sequential time steps with R held in VMEM and the
state in VMEM scratch). Two kernels compute that function, and `route`
picks one by a stated rule:

  sm90 — `csrc/slstm_sm90.cu`: a persistent, cooperatively launched grid
         of one block per SM, each holding its channels' slice of R in
         shared memory for the whole sequence, with one grid-wide barrier
         a step; for every call whose slices fit (xlstm-125m's D = 768
         with R in float32 or bfloat16 included);
  rows — `csrc/slstm.cu`: one thread block per batch row, streaming R
         from L2 every step; for the rest (wide D, more than 32 rows).

Each source note says what bounds its kernel and why it is shaped so. The
plain version is `repro_torch.kernels.ref.slstm_ref`.

`slstm()` takes CUDA tensors only: it checks device, dtype, shape and
contiguity and raises on anything else, allocates its outputs, launches on
the current stream and raises on a CUDA launch error (a grid that cannot
be co-resident included). Each kernel's wrapper (`slstm_sm90`,
`slstm_rows`) counts its own launches where it launches; `launches()` is
their sum. The libraries are built at first use by
`repro_torch.kernel_build` (nvcc, sm_90a) and bound with ctypes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import kernel_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "slstm.cu"
SOURCE_SM90 = Path(__file__).resolve().parent / "csrc" / "slstm_sm90.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the widest D the rows kernel takes (8 channels per thread, 1024 threads)
MAX_D = 8192
#: the sm90 kernel's grid: at most this many blocks (the H100 SXM has 132
#: SMs), so ceil(D / GRID_BLOCKS) channels per block; `chip_smoke.py`
#: times 48, 64, 96 and 128 blocks at D = 768 (PERF.md)
GRID_BLOCKS = 96
#: the sm90 kernel's limits: one batch row per lane, one channel per warp
#: (16 warps a block), and the shared memory a block can have
GRID_MAX_B = 32
GRID_MAX_CHANNELS = 16
SMEM_MAX = 232448

_LAUNCH = {}


def _launcher(source: Path):
    """A kernel's C launch function, built and bound at first use."""
    fn = _LAUNCH.get(source)
    if fn is None:
        lib = kernel_build.load(source)
        if source == SOURCE_SM90:
            # 12 tensors, hbuf, bar; batch, T, D, wx_bf16, r_bf16; the
            # geometry (channels, tile, dp, rs, smem)
            fn = lib.slstm_sm90_launch
            fn.argtypes = [ctypes.c_void_p] * 14 + [
                ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        else:
            fn = lib.slstm_launch
            fn.argtypes = [ctypes.c_void_p] * 12 + [
                ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH[source] = fn
    return fn


class Geometry(NamedTuple):
    """The sm90 kernel's launch geometry, computed here only and passed to
    its C launch function, which checks it against the card's limits."""
    channels: int   # channels per block, so ceil(D / channels) blocks
    tile: int       # batch rows formed together: 1, 2 or 4
    dp: int         # D rounded up to 4: h's row stride in shared memory
    rs: int         # dp + 4: R's row stride, spreading the copy over banks
    smem: int       # shared bytes per block: R's slice, then h


def grid_geometry(b: int, d: int, r_dtype: torch.dtype,
                  blocks: int = GRID_BLOCKS) -> Geometry:
    """The sm90 kernel's geometry for B rows of width D on at most `blocks`
    blocks: R's slice as ch x 4 rows of `rs` elements in R's dtype, and h
    for B rows rounded up to the batch tile in float32."""
    ch = -(-d // blocks)
    dp = -(-d // 4) * 4
    tile = 1 if b == 1 else 2 if b == 2 else 4
    bp = -(-b // tile) * tile
    size = 4 if r_dtype == torch.float32 else 2
    smem = ch * 4 * (dp + 4) * size + bp * dp * 4
    return Geometry(ch, tile, dp, dp + 4, smem)


def route(wx: torch.Tensor, r_gates: torch.Tensor) -> str:
    """Which kernel takes (wx, r_gates): "sm90" or "rows". A pure function
    of dtype and shape, on any device. "sm90" takes float32 or bfloat16 wx
    and R with B <= 32 whose grid needs at most 16 channels a block and
    227 KB of shared memory a block (D up to 1152 with R in float32, 1536
    in bfloat16); everything else goes to "rows"."""
    b, d = int(wx.shape[0]), int(wx.shape[-1])
    if wx.dtype not in _DTYPES or r_gates.dtype not in _DTYPES or \
            not 1 <= b <= GRID_MAX_B or d < 1:
        return "rows"
    g = grid_geometry(b, d, r_gates.dtype)
    return ("sm90" if g.channels <= GRID_MAX_CHANNELS and g.smem <= SMEM_MAX
            else "rows")


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


def _check_all(wx, r_gates, b_gates, h0, c0, n0, m0) -> Tuple[int, int, int]:
    """Raise on what neither kernel takes; return (B, T, D)."""
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
    return b, t, d


def _launch(source: Path, dims, wx, r_gates, b_gates, h0, c0, n0, m0,
            geom: Optional[Geometry] = None):
    """Launch `source`'s kernel on inputs `_check_all` passed (`dims` is
    what it returned); the sm90 kernel on `geom`."""
    b, t, d = dims
    launch = _launcher(source)
    y = torch.empty((b, t, d), dtype=wx.dtype, device=wx.device)
    h, c, n, m = (torch.empty((b, d), dtype=torch.float32, device=wx.device)
                  for _ in range(4))
    ptrs = [a.data_ptr() for a in (wx, r_gates, b_gates, h0, c0, n0, m0, y,
                                   h, c, n, m)]
    stream = torch.cuda.current_stream(wx.device).cuda_stream
    dtypes = (_DTYPES[wx.dtype], _DTYPES[r_gates.dtype])
    with torch.cuda.device(wx.device):
        if source == SOURCE_SM90:
            # h's two halves, and the barrier's arrival counter
            hbuf = torch.empty((2, b, d), dtype=torch.float32,
                               device=wx.device)
            bar = torch.zeros(1, dtype=torch.int64, device=wx.device)
            rc = launch(*ptrs, hbuf.data_ptr(), bar.data_ptr(), b, t, d,
                        *dtypes, *geom, stream)
        else:
            rc = launch(*ptrs, b, t, d, *dtypes, stream)
    if rc != 0:
        raise RuntimeError(f"{source.name} kernel launch failed: cudaError "
                           f"{rc} (720: the grid cannot be co-resident)")
    return y, (h, c, n, m)


def slstm_rows(wx: torch.Tensor, r_gates: torch.Tensor, b_gates: torch.Tensor,
               h0: torch.Tensor, c0: torch.Tensor, n0: torch.Tensor,
               m0: torch.Tensor) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One launch of the one-block-per-row kernel (any B, D <= 8192)."""
    dims = _check_all(wx, r_gates, b_gates, h0, c0, n0, m0)
    out = _launch(SOURCE, dims, wx, r_gates, b_gates, h0, c0, n0, m0)
    slstm_rows.launches += 1
    return out


def slstm_sm90(wx: torch.Tensor, r_gates: torch.Tensor, b_gates: torch.Tensor,
               h0: torch.Tensor, c0: torch.Tensor, n0: torch.Tensor,
               m0: torch.Tensor) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One launch of the persistent-grid kernel: inputs that `route` sends
    to "sm90" only (raises on others)."""
    dims = _check_all(wx, r_gates, b_gates, h0, c0, n0, m0)
    if route(wx, r_gates) != "sm90":
        raise ValueError(f"slstm_sm90: takes B <= {GRID_MAX_B} and R slices "
                         f"that fit shared memory; got B {dims[0]}, D "
                         f"{dims[2]}, R {r_gates.dtype}")
    out = _launch(SOURCE_SM90, dims, wx, r_gates, b_gates, h0, c0, n0, m0,
                  grid_geometry(dims[0], dims[2], r_gates.dtype))
    slstm_sm90.launches += 1
    return out


def slstm(wx: torch.Tensor, r_gates: torch.Tensor, b_gates: torch.Tensor,
          h0: torch.Tensor, c0: torch.Tensor, n0: torch.Tensor,
          m0: torch.Tensor) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One launch of the kernel `route` picks: wx [B, T, 4, D] in float32
    or bfloat16, r_gates [D, 4, D] and b_gates [4, D] both float32 or both
    bfloat16, h0, c0, n0, m0 float32 [B, D]. Returns (y [B, T, D] in wx's
    dtype, (h, c, n, m) float32 [B, D])."""
    kernel = slstm_sm90 if route(wx, r_gates) == "sm90" else slstm_rows
    return kernel(wx, r_gates, b_gates, h0, c0, n0, m0)


def launches() -> int:
    """Launches of both kernels so far (each wrapper counts its own)."""
    return slstm_sm90.launches + slstm_rows.launches


slstm_rows.launches = 0
slstm_sm90.launches = 0
