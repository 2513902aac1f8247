"""The CiM engine's op catalogue: everything ONE ADRA access can emit.

Port of `repro.cim.opset`. One asymmetric dual-row activation yields the
signal set {OR, AND, B} (and A via the OAI21 gate); from it the peripheral
logic derives the add and sub plane stacks, the carry-outs, the lt/eq/gt
bitmaps and any of the 16 two-input Boolean functions. Planes are int32
tensors holding uint32 bit patterns (see `repro_torch.core.bitplane`).
"""
from __future__ import annotations

from typing import Tuple

import torch


class CimOpError(ValueError):
    """A malformed CiM op request (unknown op, empty/duplicate op-set, bad
    Boolean function name)."""


#: the 16 two-input Boolean functions, minterm order
BOOLEAN_OPS: Tuple[str, ...] = (
    "false", "nor", "a_and_not_b", "not_b", "not_a_and_b", "not_a",
    "xor", "nand", "and", "xnor", "a", "a_or_not_b", "b", "not_a_or_b",
    "or", "true",
)

#: arithmetic plane stacks — (n_bits+1) planes incl. the overflow module
ARITH_OPS: Tuple[str, ...] = ("add", "sub")

#: per-word predicate bitmaps — one row
PREDICATE_OPS: Tuple[str, ...] = ("lt", "eq", "gt", "carry_add", "carry_sub")

ALL_OPS: Tuple[str, ...] = ARITH_OPS + PREDICATE_OPS + BOOLEAN_OPS

#: predicates derived from the subtraction ripple chain
_SUB_DERIVED = ("sub", "lt", "eq", "gt", "carry_sub")
_ADD_DERIVED = ("add", "carry_add")


def validate_ops(ops: Tuple[str, ...]) -> Tuple[str, ...]:
    ops = tuple(ops)
    if not ops:
        raise CimOpError("empty op request")
    for op in ops:
        if op not in ALL_OPS:
            raise CimOpError(f"unknown CiM op {op!r}; valid: {ALL_OPS}")
    if len(set(ops)) != len(ops):
        raise CimOpError(f"duplicate ops in request: {ops}")
    return ops


def needs_add_chain(ops) -> bool:
    return any(o in _ADD_DERIVED for o in ops)


def needs_sub_chain(ops) -> bool:
    return any(o in _SUB_DERIVED for o in ops)


def out_rows(op: str, n_bits: int) -> int:
    """Plane rows of one output: arith stacks carry the overflow plane."""
    if op in ARITH_OPS:
        return n_bits + 1
    if op in PREDICATE_OPS:
        return 1
    return n_bits


def out_signed(op: str) -> bool:
    return op in ARITH_OPS


def boolean_plane(fn: str, or_: torch.Tensor, and_: torch.Tensor,
                  b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """One Boolean-function plane from the single-access signal set,
    composed exactly from {OR, AND, B, A} and complements."""
    if fn == "false":
        return torch.zeros_like(or_)
    if fn == "true":
        return ~torch.zeros_like(or_)
    return {
        "nor": lambda: ~or_,
        "a_and_not_b": lambda: or_ & ~b,
        "not_b": lambda: ~b,
        "not_a_and_b": lambda: or_ & ~a,
        "not_a": lambda: ~a,
        "xor": lambda: or_ & ~and_,
        "nand": lambda: ~and_,
        "and": lambda: and_,
        "xnor": lambda: ~(or_ & ~and_),
        "a": lambda: a,
        "a_or_not_b": lambda: ~(or_ & ~a),   # a | ~b == ~(~a & b)
        "b": lambda: b,
        "not_a_or_b": lambda: ~(or_ & ~b),   # ~a | b == ~(a & ~b)
        "or": lambda: or_,
    }[fn]()


def oai21_recover_a_planes(or_: torch.Tensor, and_: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """A = NOT(NAND(A,B) * (B + NOR(A,B))) — the OAI21 gate, plane-wise."""
    return ~(~and_ & (b | ~or_))
