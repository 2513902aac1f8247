"""High-level ADRA CiM ops: the paper's technique as plain functions on tensors.

Port of `repro.core.adra`. Two execution models share one semantics:

  * mode="analog"  -- the faithful path: per-bit senseline currents from the
    calibrated FeFET device model, thresholded against the SA references,
    then the gate-level compute-module ripple. This is the *paper*.
  * mode="boolean" -- the same dataflow with ideal SAs (pure Boolean OR/AND/B).

All ops take ordinary integer tensors (any shape, any device), decompose to
two's-complement bit-planes, run the single-access ADRA dataflow on the
inputs' device, and re-assemble. A single "memory access" yields OR, AND and
B simultaneously — hence add, sub, compare and ALL 16 two-input Boolean
functions each cost exactly one access, which is what the energy model
(repro_torch.core.energy) charges for.

This module is the semantic oracle of the CiM engine: the engine's
analog-oracle backend (`repro_torch.cim.backends`) routes packed bit-planes
through `adra_access(mode="analog")` and the gate-level compute modules
here, holding every fast backend (the fused CUDA kernel, the plain plane
math) to what the sensed circuit computes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .array import AdraArrayConfig, senseline_current
from .bitplane import bits_to_int, int_to_bits
from .compute_module import compare_from_sub, ripple_chain, ripple_chain_dual
from .sensing import SenseOutputs, SenseReferences, oai21_recover_a, sense


class AccessOutputs(NamedTuple):
    """What one ADRA memory access yields, per bit position."""

    or_: torch.Tensor
    and_: torch.Tensor
    b: torch.Tensor
    a: torch.Tensor


def adra_access(a_bits, b_bits, mode: str = "boolean",
                cfg: Optional[AdraArrayConfig] = None) -> AccessOutputs:
    """One asymmetric dual-row activation over bit tensors (0/1 ints).

    Returns the three SA outputs plus the OAI-recovered A. In analog mode the
    currents are computed from the device model and sensed against references
    derived from the level currents, verifying the circuit actually realizes
    the Boolean contract.
    """
    a_bits = torch.as_tensor(a_bits).to(torch.int32)
    b_bits = torch.as_tensor(b_bits).to(torch.int32)
    if mode == "analog":
        cfg = cfg or AdraArrayConfig()
        refs = SenseReferences.from_config(cfg)
        i_sl = senseline_current(a_bits, b_bits, cfg, asymmetric=True)
        s: SenseOutputs = sense(i_sl, refs)
        return AccessOutputs(or_=s.or_, and_=s.and_, b=s.b, a=s.a)
    if mode == "boolean":
        or_ = a_bits | b_bits
        and_ = a_bits & b_bits
        a_rec = oai21_recover_a(or_, and_, b_bits)
        return AccessOutputs(or_=or_, and_=and_, b=b_bits, a=a_rec)
    raise ValueError(f"unknown mode: {mode!r}")


def _access(x, y, n_bits: int, mode: str) -> AccessOutputs:
    return adra_access(int_to_bits(x, n_bits), int_to_bits(y, n_bits),
                       mode=mode)


# ---------------------------------------------------------------------------
# Arithmetic (single-access add / sub / compare)
# ---------------------------------------------------------------------------


class ArithOut(NamedTuple):
    value: torch.Tensor        # integer result, (n+1)-bit two's complement
    sum_bits: torch.Tensor     # raw module outputs [..., n+1]
    carry_out: torch.Tensor


def _arith(x, y, n_bits: int, select: int, mode: str) -> ArithOut:
    acc = _access(x, y, n_bits, mode)
    sum_bits, c_out = ripple_chain(acc.or_, acc.and_, acc.b, select=select)
    return ArithOut(value=bits_to_int(sum_bits, signed=True),
                    sum_bits=sum_bits, carry_out=c_out)


def cim_add(x, y, n_bits: int = 32, mode: str = "boolean") -> ArithOut:
    """x + y via ADRA: one access + (n+1) compute modules, SELECT=0."""
    return _arith(x, y, n_bits, select=0, mode=mode)


def cim_sub(x, y, n_bits: int = 32, mode: str = "boolean") -> ArithOut:
    """x - y via ADRA: one access + (n+1) compute modules, SELECT=1.

    This is the paper's headline capability: single-cycle NON-commutative
    arithmetic, impossible under symmetric multi-wordline CiM.
    """
    return _arith(x, y, n_bits, select=1, mode=mode)


class CmpOut(NamedTuple):
    lt: torch.Tensor
    eq: torch.Tensor
    gt: torch.Tensor


def cim_compare(x, y, n_bits: int = 32, mode: str = "boolean") -> CmpOut:
    """Single-access comparison: sign + AND-tree over the subtraction output."""
    out = _arith(x, y, n_bits, select=1, mode=mode)
    c = compare_from_sub(out.sum_bits)
    return CmpOut(lt=c.lt, eq=c.eq, gt=c.gt)


# ---------------------------------------------------------------------------
# All 16 two-input Boolean functions from one access
# ---------------------------------------------------------------------------

#: minterm weights (m3 m2 m1 m0) for f(A,B); index = m3*8+m2*4+m1*2+m0 with
#: minterms (A,B): m0=(0,0), m1=(0,1), m2=(1,0), m3=(1,1)
BOOLEAN_FUNCTIONS = (
    "false", "nor", "a_and_not_b", "not_b", "not_a_and_b", "not_a",
    "xor", "nand", "and", "xnor", "a", "a_or_not_b", "b", "not_a_or_b",
    "or", "true",
)


def _boolean_bits(fn: str, acc: AccessOutputs) -> torch.Tensor:
    """One function's bits, composed from the access outputs {OR, AND, B,
    A} and their complements — the signal set the three SAs + OAI gate
    provide."""
    o, n, b, a = acc.or_, acc.and_, acc.b, acc.a
    table = {
        "false": lambda: torch.zeros_like(o),
        "nor": lambda: 1 - o,
        "a_and_not_b": lambda: o & (1 - b),
        "not_b": lambda: 1 - b,
        "not_a_and_b": lambda: o & (1 - a),
        "not_a": lambda: 1 - a,
        "xor": lambda: o & (1 - n),
        "nand": lambda: 1 - n,
        "and": lambda: n,
        "xnor": lambda: 1 - (o & (1 - n)),
        "a": lambda: a,
        "a_or_not_b": lambda: 1 - (o & (1 - a)),   # a | ~b == ~(~a & b)
        "b": lambda: b,
        "not_a_or_b": lambda: 1 - (o & (1 - b)),   # ~a | b == ~(a & ~b)
        "or": lambda: o,
        "true": lambda: torch.ones_like(o),
    }
    return table[fn]()


def cim_boolean(x, y, fn: str, n_bits: int = 32,
                mode: str = "boolean") -> torch.Tensor:
    """Any two-input Boolean function of in-memory words, one access."""
    acc = _access(x, y, n_bits, mode)
    return bits_to_int(_boolean_bits(fn, acc), signed=False)


class AddSubOut(NamedTuple):
    add: torch.Tensor
    sub: torch.Tensor


def cim_add_sub(x, y, n_bits: int = 32, mode: str = "boolean") -> AddSubOut:
    """Paper Sec. III-B alternate module: x+y AND x-y from ONE access, the
    same cycle (dual-output design, +4 transistors over the mux design)."""
    acc = _access(x, y, n_bits, mode)
    sa, ss = ripple_chain_dual(acc.or_, acc.and_, acc.b)
    return AddSubOut(add=bits_to_int(sa, signed=True),
                     sub=bits_to_int(ss, signed=True))
