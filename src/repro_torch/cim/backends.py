"""CiM backend registry: one dispatch point for every ADRA execution model.

Port of `repro.cim.backends`. A backend is a callable over packed planes:

    fn(a_planes int32[n, W], b_planes int32[n, W], ops: tuple[str, ...])
        -> tuple[torch.Tensor, ...]   # one output per op, opset shape rules

and takes a leading tile axis, [T, n, W], with outputs in the same layout.

Registered backends:

  fused          — the fused bit-plane kernel's wrapper
                   (`fused_kernel.fused_planes_op`): the CUDA kernel for
                   CUDA tensors, its plain version for CPU tensors
  torch-boolean  — the plain PyTorch plane math on any device (the port of
                   `_jnp_boolean_backend`, ideal SAs)
  analog-oracle  — per-bit senseline currents from the calibrated FeFET
                   device model, thresholded against the SA references
                   (`repro_torch.core.adra`, mode="analog"), then the
                   gate-level ripple of the compute module, on the planes'
                   device: the slow path that IS the paper, used to validate
                   every other backend

Resolution order: explicit argument > REPRO_TORCH_CIM_BACKEND env var >
`set_default_backend()` > "fused". The env var is the port's own, so the
reference's REPRO_CIM_BACKEND never hands it a name it lacks.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.adra import adra_access
from repro_torch.core.bitplane import _pack_lanes, unpack_lanes
from repro_torch.core.compute_module import compare_from_sub, ripple_chain
from . import opset
from .fused_kernel import fused_planes_op, fused_planes_op_ref

BackendFn = Callable[[torch.Tensor, torch.Tensor, Tuple[str, ...]],
                     Tuple[torch.Tensor, ...]]

ENV_VAR = "REPRO_TORCH_CIM_BACKEND"


@dataclasses.dataclass(frozen=True)
class Backend:
    name: str
    fn: BackendFn
    description: str

    def __call__(self, a_planes, b_planes, ops):
        return self.fn(a_planes, b_planes, ops)


_REGISTRY: Dict[str, Backend] = {}
_DEFAULT_OVERRIDE: Optional[str] = None


def register_backend(name: str, fn: BackendFn, description: str = "") -> Backend:
    bk = Backend(name=name, fn=fn, description=description)
    _REGISTRY[name] = bk
    return bk


def available_backends() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def set_default_backend(name: Optional[str]) -> None:
    """Process-wide default (None restores "fused")."""
    global _DEFAULT_OVERRIDE
    if name is not None and name not in _REGISTRY:
        raise KeyError(f"unknown backend {name!r}; have {available_backends()}")
    _DEFAULT_OVERRIDE = name


def default_backend_name() -> str:
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    if _DEFAULT_OVERRIDE:
        return _DEFAULT_OVERRIDE
    return "fused"


def get_backend(name: Optional[str] = None) -> Backend:
    name = name or default_backend_name()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown CiM backend {name!r}; have {available_backends()}") from None


# ---------------------------------------------------------------------------
# analog-oracle: the device-model path from repro_torch.core.adra, per bit
# ---------------------------------------------------------------------------

#: bit positions (lanes x 32 words x planes) one chunk of an analog pass
#: evaluates. The reference builds one [W*32, n] bit matrix per operand:
#: 7.8 GB at the main path's largest access (29 planes x 2^21 lanes) before
#: any float current. In chunks of 2^25 each int32 bit tensor and float32
#: current of the device model holds 128 MiB, so a pass stays within a few
#: GiB whatever the width; words are independent, so chunking changes no
#: result.
ANALOG_CHUNK_BITS = 1 << 25


def _planes_to_bits(planes: torch.Tensor) -> torch.Tensor:
    """int32[rows, L] planes -> int32[L*32, rows] 0/1 bits: word-major
    indexing (the reference's layout) over a plane-major tensor."""
    return unpack_lanes(planes).T


def _bits_to_planes(bits: torch.Tensor) -> torch.Tensor:
    """int32[L*32, rows] 0/1 -> int32[rows, L] packed planes."""
    return _pack_lanes(bits.T)


def _analog_chunk(a_planes, b_planes, ops):
    """One chunk of lanes: unpack to bits, run the sensed analog dataflow,
    repack."""
    acc = adra_access(_planes_to_bits(a_planes), _planes_to_bits(b_planes),
                      mode="analog")
    results: Dict[str, torch.Tensor] = {}
    if opset.needs_add_chain(ops):
        sum_bits, c_out = ripple_chain(acc.or_, acc.and_, acc.b, select=0)
        results["add"] = _bits_to_planes(sum_bits)
        results["carry_add"] = _bits_to_planes(c_out[:, None])
    if opset.needs_sub_chain(ops):
        sum_bits, c_out = ripple_chain(acc.or_, acc.and_, acc.b, select=1)
        results["sub"] = _bits_to_planes(sum_bits)
        results["carry_sub"] = _bits_to_planes(c_out[:, None])
        c = compare_from_sub(sum_bits)
        results["lt"] = _bits_to_planes(c.lt[:, None])
        results["eq"] = _bits_to_planes(c.eq[:, None])
        results["gt"] = _bits_to_planes(c.gt[:, None])
    for fn in ops:
        if fn in opset.BOOLEAN_OPS:
            results[fn] = _bits_to_planes(opset.boolean_plane(
                fn, acc.or_, acc.and_, acc.b, acc.a) & 1)
    return tuple(results[op] for op in ops)


def _analog_oracle_backend(a_planes, b_planes, ops):
    """The device model per bit, on the planes' device, in chunks of
    ANALOG_CHUNK_BITS. Slow by design. Takes [n, W] or [T, n, W] stacks of
    any strides; outputs in the input's layout."""
    ops = opset.validate_ops(ops)
    if a_planes.shape != b_planes.shape or a_planes.dim() not in (2, 3):
        raise opset.CimOpError(
            f"plane stacks must share a [n_bits, W] or [T, n_bits, W] shape, "
            f"got {tuple(a_planes.shape)} and {tuple(b_planes.shape)}")
    if a_planes.dim() == 3:
        # the tile axis joins the lanes: [T, n, W] -> [n, T*W] and back
        t, n, w = a_planes.shape
        outs = _analog_oracle_backend(
            a_planes.transpose(0, 1).reshape(n, t * w),
            b_planes.transpose(0, 1).reshape(n, t * w), ops)
        return tuple(o.view(o.shape[0], t, w).transpose(0, 1).contiguous()
                     for o in outs)
    n, w = a_planes.shape
    outs = tuple(a_planes.new_empty((opset.out_rows(op, n), w)) for op in ops)
    step = max(1, ANALOG_CHUNK_BITS // (32 * n))
    for lo in range(0, w, step):
        chunk = _analog_chunk(a_planes[:, lo:lo + step],
                              b_planes[:, lo:lo + step], ops)
        for out, part in zip(outs, chunk):
            out[:, lo:lo + step] = part
    return outs


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------

register_backend(
    "fused", lambda a, b, ops: fused_planes_op(a.contiguous(), b.contiguous(),
                                               tuple(ops)),
    "fused single-pass kernel (CUDA), plain version for CPU tensors")
register_backend(
    "torch-boolean", lambda a, b, ops: fused_planes_op_ref(a, b, tuple(ops)),
    "plain PyTorch plane math with ideal SAs")
register_backend(
    "analog-oracle", _analog_oracle_backend,
    "calibrated FeFET device model + sensed SAs (the paper, per bit)")
