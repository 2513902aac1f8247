"""The RG-LRU recurrence as CUDA kernels for Hopper.

Replaces the TPU kernel `repro.kernels.rglru._rglru_kernel` (a Pallas grid
over batch, feature blocks and sequential time blocks with h in VMEM
scratch). Two kernels compute that function, equal to the bit, and `route`
picks one by a stated rule:

  sm90 — `csrc/rglru_sm90.cu`: blocks of C contiguous channels of one
         batch row spread over every SM; a producer warp streams [T-tile x
         C] boxes of x, r and i into a ring in shared memory by TMA, gate
         warps turn them into a and m g, one scan warp walks the chain; for
         prefill (T of at least `SM90_MIN_T`);
  rows — `csrc/rglru.cu`: one thread per (b, d) channel walking all of T;
         for decode and short T, and for what TMA cannot address.

Each source note says what bounds its kernel and why it is shaped so. The
plain version is `repro_torch.kernels.ref.rglru_ref`.

`rglru()` takes CUDA tensors only: it checks device, dtype, shape and
contiguity and raises on anything else, allocates its outputs, launches on
the current stream and raises on a CUDA launch error. Each kernel's
wrapper (`rglru_sm90`, `rglru_rows`) counts its own launches where it
launches; `launches()` is their sum. The libraries are built at first use
by `repro_torch.kernel_build` (nvcc, sm_90a) and bound with ctypes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import kernel_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru.cu"
SOURCE_SM90 = Path(__file__).resolve().parent / "csrc" / "rglru_sm90.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the shortest T that `route` sends to the sm90 kernel: below it the rows
#: kernel's few steps cost less device time than the sm90 kernel's pipeline
#: start (`chip_smoke.py`'s T sweep at D = 4096, B = 1 and 2; PERF.md)
SM90_MIN_T = 8
#: sm90 geometry (`chip_smoke.py` sweeps C, the ring and the warps; PERF.md):
#: channels a block, the wider when its grid still covers `FILL_BLOCKS`
#: (0.97 of the H100's `SMS` SMs); steps a tile (the kernel's TILE_T);
#: input ring depth; warps a block, 24 where each SM holds one block (the
#: gate warps' IEEE divisions and square roots need many warps in flight),
#: 12 where two blocks fit an SM's shared memory (`SM_SMEM`)
CHANNELS = (32, 16)
SMS = 132
FILL_BLOCKS = 128
TILE_T = 64
STAGES = 4
WARPS = (24, 12)
SM_SMEM = 233472
#: the shared-memory layout's fixed parts (csrc/rglru_sm90.cu): gate and
#: output tiles double buffered, a 128-byte aligned base, the block's limit
_GATE_STAGES = 2
_Y_STAGES = 2
_ALIGN = 128
SMEM_MAX = 232448

_LAUNCH = {}


def _launcher(source: Path):
    """A kernel's C launch function, built and bound at first use."""
    fn = _LAUNCH.get(source)
    if fn is None:
        lib = kernel_build.load(source)
        common = [ctypes.c_void_p] * 7 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_float]
        if source == SOURCE_SM90:
            # x, r, i, log_lambda, h0, y, h_out; batch, T, D, is_bf16, c;
            # the geometry (channels, stages, warps, blocks, smem); the
            # stream
            fn = lib.rglru_sm90_launch
            fn.argtypes = common + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        else:
            fn = lib.rglru_launch
            fn.argtypes = common + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH[source] = fn
    return fn


class Geometry(NamedTuple):
    """The sm90 kernel's launch geometry, computed here only and passed to
    its C launch function, which checks it."""
    channels: int     # C: channels of one batch row per block
    stages: int       # input ring depth (x, r, i tiles per stage)
    warps: int        # warps a block: a producer, a scan warp, the gates
    blocks: int       # B * ceil(D / C)
    smem: int         # dynamic shared bytes per block


def gate_warps(warps: int) -> int:
    """The gate warps of a block of `warps`: all but the producer (warp 0),
    the scan warp (1) and the warps that share the scan warp's
    sub-partition (5, 9, ...), which leave at once."""
    return (warps - 2) - (warps - 2) // 4


def tile_geometry(b: int, t: int, d: int, dtype: torch.dtype,
                  channels: Optional[int] = None, stages: int = STAGES,
                  warps: Optional[int] = None) -> Geometry:
    """The sm90 kernel's geometry for [B, T, D] in `dtype`: C = 32 channels
    a block when B * ceil(D / 32) blocks still cover `FILL_BLOCKS`, else 16
    (twice the blocks); the input ring, gate ring ((a, m g) pairs) and
    output ring of [TILE_T x C] tiles in shared memory, then the barriers;
    24 warps a block, or 12 when the grid is larger than the card and two
    blocks fit an SM. T does not change the geometry (the last tile is
    masked)."""
    isz = 4 if dtype == torch.float32 else 2
    if channels is None:
        wide = CHANNELS[0]
        channels = wide if b * -(-d // wide) >= FILL_BLOCKS else CHANNELS[1]
    blocks = b * -(-d // channels)
    tile = TILE_T * channels
    smem = (stages * 3 * tile * isz + _GATE_STAGES * tile * 8
            + _Y_STAGES * tile * isz + 8 * (2 * stages + 2 * _GATE_STAGES)
            + _ALIGN)
    if warps is None:
        shared = blocks > SMS and 2 * smem <= SM_SMEM
        warps = WARPS[1] if shared else WARPS[0]
    return Geometry(channels, stages, warps, blocks, smem)


def sm90_takes(x: torch.Tensor, *gates: torch.Tensor) -> bool:
    """Whether the sm90 kernel can take x (and the gates r, i): [B, T, D]
    float32 or bfloat16 that TMA can address, contiguous, 16-byte-aligned
    data and D * itemsize a multiple of 16 (every stride then is)."""
    if x.dim() != 3 or x.dtype not in _DTYPES:
        return False
    if (int(x.shape[-1]) * x.element_size()) % 16:
        return False
    return all(a.is_contiguous() and a.data_ptr() % 16 == 0
               for a in (x, *gates))


def route(x: torch.Tensor, *gates: torch.Tensor) -> str:
    """Which kernel takes x (and its gates r, i): "sm90" or "rows". A pure
    function of dtype, shape, strides and alignment, on any device: "sm90"
    for T >= SM90_MIN_T that `sm90_takes`, everything else (decode, short T,
    D * itemsize not a multiple of 16) "rows"."""
    if x.dim() != 3 or int(x.shape[1]) < SM90_MIN_T:
        return "rows"
    return "sm90" if sm90_takes(x, *gates) else "rows"


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"rglru: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"rglru: {name} is {t.dtype}, expected {dtype}; "
                         f"the plain version kernels.ref.rglru_ref takes "
                         f"others")
    if not t.is_contiguous():
        raise ValueError(f"rglru: {name} must be contiguous; the plain "
                         f"version kernels.ref.rglru_ref takes any strides")
    if t.device != device:
        raise ValueError(f"rglru: {name} on {t.device}, x on {device}")


def _check_all(x, r, i, log_lambda, h0) -> Tuple[int, int, int]:
    """Raise on what neither kernel takes; return (B, T, D)."""
    if x.dim() != 3 or x.dtype not in _DTYPES:
        raise ValueError(f"rglru: x must be [B, T, D] float32 or bfloat16, "
                         f"got {tuple(x.shape)} {x.dtype}; the plain version "
                         f"kernels.ref.rglru_ref takes others")
    b, t, d = (int(s) for s in x.shape)
    if min(b, t, d) < 1 or b * d >= 2 ** 31:
        raise ValueError(f"rglru: empty or oversized shape {(b, t, d)}")
    for name, ten in (("x", x), ("r", r), ("i", i)):
        _check(name, ten, (b, t, d), x.dtype, x.device)
    _check("log_lambda", log_lambda, (d,), torch.float32, x.device)
    if h0 is not None:
        _check("h0", h0, (b, d), torch.float32, x.device)
    if x.device.type != "cuda":
        raise ValueError(
            f"rglru: the kernel takes CUDA tensors, got {x.device}; CPU "
            f"tensors go through kernels.ops.rglru_scan's plain version "
            f"(kernels.ref.rglru_ref)")
    return b, t, d


def _launch(source: Path, dims, x, r, i, log_lambda, h0, c: float,
            geom: Optional[Geometry] = None):
    """Launch `source`'s kernel on inputs `_check_all` passed (`dims` is
    what it returned); the sm90 kernel on `geom`."""
    b, t, d = dims
    launch = _launcher(source)
    y = torch.empty_like(x)
    h_out = torch.empty((b, d), dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), r.data_ptr(), i.data_ptr(), log_lambda.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_out.data_ptr(), b, t, d, _DTYPES[x.dtype], float(c))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if source == SOURCE_SM90:
            rc = launch(*args, *geom, stream)
        else:
            rc = launch(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{source.name} kernel launch failed: cudaError "
                           f"{rc} (1001-1003: tensor map or geometry)")
    return y, h_out


def rglru_rows(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
               log_lambda: torch.Tensor, h0: Optional[torch.Tensor] = None,
               c: float = 8.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the one-thread-per-channel kernel (any B, T, D)."""
    dims = _check_all(x, r, i, log_lambda, h0)
    out = _launch(SOURCE, dims, x, r, i, log_lambda, h0, c)
    rglru_rows.launches += 1
    return out


def rglru_sm90(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
               log_lambda: torch.Tensor, h0: Optional[torch.Tensor] = None,
               c: float = 8.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the TMA channel-tile kernel, any T, on inputs that
    `sm90_takes` (raises on others)."""
    dims = _check_all(x, r, i, log_lambda, h0)
    if not sm90_takes(x, r, i):
        raise ValueError(f"rglru_sm90: takes D * itemsize a multiple of 16 "
                         f"and 16-byte-aligned data; got D {dims[2]} "
                         f"{x.dtype}; csrc/rglru.cu and the plain version "
                         f"kernels.ref.rglru_ref take it")
    out = _launch(SOURCE_SM90, dims, x, r, i, log_lambda, h0, c,
                  tile_geometry(*dims, x.dtype))
    rglru_sm90.launches += 1
    return out


def rglru(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
          log_lambda: torch.Tensor, h0: Optional[torch.Tensor] = None,
          c: float = 8.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel `route` picks: x, r, i [B, T, D] in float32
    or bfloat16, log_lambda float32 [D], h0 float32 [B, D] or None. Returns
    (y [B, T, D] in x's dtype, h_T float32 [B, D])."""
    kernel = rglru_sm90 if route(x, r, i) == "sm90" else rglru_rows
    return kernel(x, r, i, log_lambda, h0=h0, c=c)


def launches() -> int:
    """Launches of both kernels so far (each wrapper counts its own)."""
    return rglru_sm90.launches + rglru_rows.launches


rglru_rows.launches = 0
rglru_sm90.launches = 0
