"""The fused bit-plane kernel: ANY subset of the CiM op catalogue from ONE
pass over both plane stacks — the port of `repro.cim.fused_kernel`.

The TPU kernel (`_fused_kernel`, a Pallas grid over 512-lane blocks) is
replaced by a CUDA kernel written for Hopper, `csrc/fused_planes.cu`: one
thread per packed column looping over the planes with the carries in
registers, the op subset as a bitmask, the ragged edge masked in-kernel.
Its source note says what bounds it and why it is shaped so.

Beside it, `fused_planes_op_ref` is the plain PyTorch version (the port of
`repro.cim.backends._jnp_boolean_backend`). `fused_planes_op`, the wrapper,
takes it only for tensors that lie on the CPU; for CUDA tensors it launches
the kernel or raises — there is no fallback.

Build: at first use `repro_torch.kernel_build` compiles the source with
nvcc for sm_90a into a shared library with a plain C interface under
`build/repro_torch_kernels/` at the repository root, named by a hash of the
source, and loads it with ctypes.

Planes are int32 tensors holding uint32 bit patterns, [n_bits, W] or, with a
leading tile axis, [T, n_bits, W]; outputs follow the input layout. The
kernel's grid walks at most `MAX_TILES_PER_LAUNCH` tiles, so the wrapper
splits a longer tile axis over launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from repro_torch import kernel_build, takes_plain
from . import opset

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_planes.cu"

_OP_INDEX = {op: i for i, op in enumerate(opset.ALL_OPS)}

#: tiles one launch covers: the tile axis is the grid's y dimension
MAX_TILES_PER_LAUNCH = 65535


# ---------------------------------------------------------------------------
# the plain PyTorch version (CPU path, and the yardstick on the card)
# ---------------------------------------------------------------------------


def fused_planes_op_ref(a_planes: torch.Tensor, b_planes: torch.Tensor,
                        ops) -> Tuple[torch.Tensor, ...]:
    """The kernel's dataflow in plain PyTorch, plane by plane (ideal SAs).
    Accepts [n_bits, W] or [T, n_bits, W] stacks on any device."""
    ops = opset.validate_ops(ops)
    n_bits = a_planes.shape[-2]
    need_add = opset.needs_add_chain(ops)
    need_sub = opset.needs_sub_chain(ops)
    out: Dict[str, List[torch.Tensor]] = {
        fn: [] for fn in ops if fn in opset.BOOLEAN_OPS}
    add_planes, sub_planes = [], []

    zeros = torch.zeros_like(a_planes[..., 0, :])
    carry_a, carry_s, nz = zeros, ~zeros, zeros
    for i in range(n_bits):
        a, b = a_planes[..., i, :], b_planes[..., i, :]
        or_, and_ = a | b, a & b
        if out:
            a_rec = opset.oai21_recover_a_planes(or_, and_, b)
            for fn in out:
                out[fn].append(opset.boolean_plane(fn, or_, and_, b, a_rec))
        xor = or_ & ~and_
        if need_add:
            add_planes.append(xor ^ carry_a)
            carry_a = and_ | (carry_a & xor)
        if need_sub:
            xnor = ~xor
            s = xnor ^ carry_s
            sub_planes.append(s)
            carry_s = (or_ & ~b) | (carry_s & xnor)
            nz = nz | s

    a_msb, b_msb = a_planes[..., n_bits - 1, :], b_planes[..., n_bits - 1, :]
    results: Dict[str, torch.Tensor] = {}
    row = -2            # stack axis of the [..., rows, W] outputs
    if need_add:
        xor = a_msb ^ b_msb
        add_planes.append(xor ^ carry_a)
        results["add"] = torch.stack(add_planes, row)
        results["carry_add"] = ((a_msb & b_msb) | (carry_a & xor)).unsqueeze(row)
    if need_sub:
        nb = ~b_msb
        xnor = a_msb ^ nb
        s_ext = xnor ^ carry_s
        sub_planes.append(s_ext)
        nz = nz | s_ext
        results["sub"] = torch.stack(sub_planes, row)
        results["carry_sub"] = ((a_msb & nb) | (carry_s & xnor)).unsqueeze(row)
        results["lt"] = s_ext.unsqueeze(row)
        results["eq"] = (~nz).unsqueeze(row)
        results["gt"] = (~s_ext & nz).unsqueeze(row)
    for fn, planes in out.items():
        results[fn] = torch.stack(planes, row)
    return tuple(results[op] for op in ops)


# ---------------------------------------------------------------------------
# binding (route b: nvcc into a shared library, loaded by ctypes)
# ---------------------------------------------------------------------------

_LAUNCH = None


def _launcher():
    """The C launch function, built and bound at first use."""
    global _LAUNCH
    if _LAUNCH is None:
        fn = kernel_build.load(SOURCE).fused_planes_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_uint,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def fused_planes_op(a_planes: torch.Tensor, b_planes: torch.Tensor,
                    ops) -> Tuple[torch.Tensor, ...]:
    """One fused access; returns one plane stack per requested op, in order
    (arith: n_bits+1 rows, predicates: 1 row, Boolean functions: n_bits).

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream (or raise), once per MAX_TILES_PER_LAUNCH tiles;
    each launch adds one to `fused_planes_op.launches` and the bytes it
    must move to `fused_planes_op.bytes`: both stacks read once and every
    output plane written once, (2 n_bits + output rows) x W x 4 bytes a
    tile."""
    ops = opset.validate_ops(ops)
    if a_planes.shape != b_planes.shape or a_planes.dim() not in (2, 3):
        raise opset.CimOpError(
            f"plane stacks must share a [n_bits, W] or [T, n_bits, W] shape, "
            f"got {tuple(a_planes.shape)} and {tuple(b_planes.shape)}")
    if a_planes.device != b_planes.device:
        raise opset.CimOpError(
            f"operands on {a_planes.device} and {b_planes.device}")
    if takes_plain(a_planes):
        return fused_planes_op_ref(a_planes, b_planes, ops)
    if a_planes.device.type != "cuda":
        raise opset.CimOpError(
            f"no fused kernel for device {a_planes.device.type!r}")
    for t in (a_planes, b_planes):
        if t.dtype not in (torch.int32, torch.uint32):
            raise opset.CimOpError(f"plane stacks must be 32-bit, got {t.dtype}")
        if not t.is_contiguous():
            raise opset.CimOpError("plane stacks must be contiguous")
    tiled = a_planes.dim() == 3
    n_tiles = a_planes.shape[0] if tiled else 1
    n_bits, w = a_planes.shape[-2], a_planes.shape[-1]
    if n_bits < 1 or w < 1 or n_tiles < 1:
        raise opset.CimOpError(
            f"kernel needs n_bits >= 1, W >= 1 and a tile, got "
            f"{tuple(a_planes.shape)}")
    launch = _launcher()
    lead = (n_tiles,) if tiled else ()
    outs = [torch.empty(lead + (opset.out_rows(op, n_bits), w),
                        dtype=a_planes.dtype, device=a_planes.device)
            for op in ops]
    mask = 0
    for op in ops:
        mask |= 1 << _OP_INDEX[op]
    stream = torch.cuda.current_stream(a_planes.device).cuda_stream
    in_tile = n_bits * w * 4                          # bytes of one tile
    out_tile = [o.shape[-2] * w * 4 for o in outs]
    with torch.cuda.device(a_planes.device):
        for t0 in range(0, n_tiles, MAX_TILES_PER_LAUNCH):
            t = min(MAX_TILES_PER_LAUNCH, n_tiles - t0)
            ptrs = (ctypes.c_void_p * len(opset.ALL_OPS))()
            for op, o, ob in zip(ops, outs, out_tile):
                ptrs[_OP_INDEX[op]] = o.data_ptr() + t0 * ob
            rc = launch(a_planes.data_ptr() + t0 * in_tile,
                        b_planes.data_ptr() + t0 * in_tile, n_bits, w, t,
                        mask, ctypes.cast(ptrs, ctypes.c_void_p), stream)
            if rc != 0:
                raise RuntimeError(
                    f"fused_planes kernel launch failed: cudaError {rc}")
            fused_planes_op.launches += 1
            fused_planes_op.bytes += (2 * in_tile + sum(out_tile)) * t
    return tuple(outs)


fused_planes_op.launches = 0
fused_planes_op.bytes = 0
