"""The unified CiM engine: one dispatch point for every ADRA operation.

Port of `repro.cim.engine`: `execute` runs any subset of the op catalogue
over two PlanePacks in ONE simulated memory access on the selected backend
and returns PlanePacks, so chained ops stay packed. `execute_unfused` is the
near-memory baseline (one access per pass) the paper argues against, and
add / sub / compare / boolean pack, execute and unpack for callers that
hold plain integer tensors. An installed fault model (`repro_torch.cim.faults`)
corrupts the streamed operands of the eager `execute` only: the traced form
a schedule program runs never injects, as the reference's jitted programs
never do.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from . import opset
from .accounting import LEDGER
from .backends import get_backend
from .fused_kernel import fused_planes_op_ref
from .planepack import PlanePack

Outputs = Dict[str, PlanePack]


def _wrap(op: str, raw: torch.Tensor, n_bits: int,
          shape: Tuple[int, ...]) -> PlanePack:
    rows = opset.out_rows(op, n_bits)
    assert raw.shape[0] == rows, (op, tuple(raw.shape), rows)
    return PlanePack(planes=raw, n_bits=rows, signed=opset.out_signed(op),
                     shape=shape)


def prepare_operands(a: PlanePack, b: PlanePack, ops: Sequence[str]
                     ) -> Tuple[PlanePack, PlanePack, Tuple[str, ...]]:
    """Validate an op request and align its operands in the packed domain."""
    ops = opset.validate_ops(tuple(ops))
    if a.shape != b.shape:
        raise opset.CimOpError(f"operand shapes differ: {a.shape} vs {b.shape}")
    a, b = a.align(b)
    if (opset.needs_add_chain(ops) or opset.needs_sub_chain(ops)) \
            and not (a.signed and b.signed):
        # the ripple chains read operands as two's complement: widen by one
        # plane so unsigned magnitudes with the top bit set stay positive
        n = a.n_bits + 1
        a, b = a.extend_to(n), b.extend_to(n)
    return a, b, ops


def execute_traced(a: PlanePack, b: PlanePack, ops: Sequence[str],
                   backend: Optional[str] = None,
                   charges: Optional[list] = None) -> Outputs:
    """The side-effect-free inner form of `execute`: no ledger mutation.
    With `charges`, appends ("access", ops, n_bits, n_words) at the
    post-alignment width — exactly what `execute` would have charged."""
    a, b, ops = prepare_operands(a, b, ops)
    bk = get_backend(backend)
    raws = bk(a.planes, b.planes, ops)
    if charges is not None:
        charges.append(("access", ops, a.n_bits, a.n_words))
    return {op: _wrap(op, raw, a.n_bits, a.shape)
            for op, raw in zip(ops, raws)}


def execute(a: PlanePack, b: PlanePack, ops: Sequence[str],
            backend: Optional[str] = None) -> Outputs:
    """One ADRA access: every requested op from a single streamed pass."""
    a, b = _fault_overlay(a, b)
    charges: list = []
    out = execute_traced(a, b, ops, backend=backend, charges=charges)
    for _, c_ops, n_bits, n_words in charges:
        LEDGER.charge(c_ops, n_bits, n_words, accesses=1)
    return out


def _fault_overlay(a: PlanePack, b: PlanePack
                   ) -> Tuple[PlanePack, PlanePack]:
    """Transient BER injection on the streamed operands of one eager access
    (the untiled path has no bank placement, so stuck-at rows do not apply
    here)."""
    from . import faults as faults_mod

    fm = faults_mod.active()
    if fm is None or fm.config.ber <= 0.0:
        return a, b
    pa, na = fm.corrupt_streamed(a.planes)
    pb, nb = fm.corrupt_streamed(b.planes)
    if na:
        a = dataclasses.replace(a, planes=pa)
    if nb:
        b = dataclasses.replace(b, planes=pb)
    return a, b


def execute_unfused(a: PlanePack, b: PlanePack,
                    passes: Sequence[Sequence[str]],
                    backend: Optional[str] = None) -> Outputs:
    """Near-memory baseline: one FULL access per pass, operands re-streamed
    each time (the paper's two-access execution, generalized to k passes)."""
    out: Outputs = {}
    for ops in passes:
        out.update(execute(a, b, ops, backend=backend))
    return out


# ---------------------------------------------------------------------------
# integer-level wrappers
# ---------------------------------------------------------------------------


class CmpOut(NamedTuple):
    lt: torch.Tensor
    eq: torch.Tensor
    gt: torch.Tensor


def _packed(x: torch.Tensor, y: torch.Tensor, n_bits: int, ops,
            backend: Optional[str]) -> Outputs:
    return execute(PlanePack.pack(x, n_bits), PlanePack.pack(y, n_bits),
                   ops, backend=backend)


def add(x: torch.Tensor, y: torch.Tensor, n_bits: int = 32,
        backend: Optional[str] = None) -> torch.Tensor:
    """x + y via one ADRA access; exact for n_bits < 32, int32 wrap at 32."""
    return _packed(x, y, n_bits, ("add",), backend)["add"].unpack()


def sub(x: torch.Tensor, y: torch.Tensor, n_bits: int = 32,
        backend: Optional[str] = None) -> torch.Tensor:
    """x - y via one ADRA access (the paper's non-commutative headline)."""
    return _packed(x, y, n_bits, ("sub",), backend)["sub"].unpack()


def compare(x: torch.Tensor, y: torch.Tensor, n_bits: int = 32,
            backend: Optional[str] = None) -> CmpOut:
    """Single-access comparison: lt/eq/gt 0/1 tensors of the operand shape."""
    out = _packed(x, y, n_bits, ("lt", "eq", "gt"), backend)
    return CmpOut(lt=out["lt"].unpack(), eq=out["eq"].unpack(),
                  gt=out["gt"].unpack())


def boolean(x: torch.Tensor, y: torch.Tensor, fn: str, n_bits: int = 32,
            backend: Optional[str] = None) -> torch.Tensor:
    """Any of the 16 two-input Boolean functions, one access."""
    if fn not in opset.BOOLEAN_OPS:
        raise opset.CimOpError(
            f"unknown Boolean function {fn!r}; valid: {opset.BOOLEAN_OPS}")
    return _packed(x, y, n_bits, (fn,), backend)[fn].unpack()


# ---------------------------------------------------------------------------
# device-memory traffic: the roofline argument, modeled and measured
# ---------------------------------------------------------------------------


def traffic_model_bytes(n_bits: int, n_words32: int,
                        ops: Sequence[str] = ("sub", "carry_sub", "lt", "eq"),
                        baseline_passes: Optional[Sequence[Sequence[str]]] = None,
                        ) -> Dict[str, float]:
    """Device-memory bytes of one fused pass vs per-pass baseline re-reads:
    the baseline re-streams both operand stacks for every pass."""
    ops = opset.validate_ops(tuple(ops))
    if baseline_passes is None:
        baseline_passes = tuple((op,) for op in ops)
    plane_bytes = 4 * n_words32
    ops_in = 2 * n_bits * plane_bytes
    out_bytes = {op: opset.out_rows(op, n_bits) * plane_bytes for op in ops}
    fused = ops_in + sum(out_bytes.values())
    baseline = sum(ops_in + sum(out_bytes[o] for o in p)
                   for p in baseline_passes)
    return {"fused": float(fused), "baseline": float(baseline),
            "ratio": baseline / fused}


def measured_traffic_bytes(a: PlanePack, b: PlanePack, ops: Sequence[str],
                           baseline_passes: Optional[Sequence[Sequence[str]]] = None
                           ) -> Dict[str, float]:
    """Like `traffic_model_bytes`, but read off the buffers one access
    streams: operand and result bytes per pass, from the plain version run
    on meta tensors (shapes only: nothing executes, nothing is charged).
    Every backend returns the stacks the op catalogue's shape rules give."""
    ops = opset.validate_ops(tuple(ops))
    if baseline_passes is None:
        baseline_passes = tuple((op,) for op in ops)
    a, b = a.align(b)
    in_bytes = a.planes.nbytes + b.planes.nbytes
    meta_a = torch.empty_like(a.planes, device="meta")
    meta_b = torch.empty_like(b.planes, device="meta")

    def pass_bytes(pass_ops):
        outs = fused_planes_op_ref(meta_a, meta_b, tuple(pass_ops))
        return in_bytes + sum(o.nbytes for o in outs)

    fused = pass_bytes(ops)
    baseline = sum(pass_bytes(p) for p in baseline_passes)
    return {"fused": float(fused), "baseline": float(baseline),
            "ratio": baseline / fused}
