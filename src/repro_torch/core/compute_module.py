"""The ADRA peripheral compute module (paper Fig. 3(d) and Sec. III-B).

Port of `repro.core.compute_module`. Inputs per bit position: the three SA
outputs OR=A+B, AND=AB, B (and their complements, free from the differential
SAs), a ripple carry C_IN, and a global SELECT line (0 = addition, 1 =
subtraction).

Derived signals (gate identities used by the module):
    XOR  = A ^ B      = OR * NOT(AND)
    XNOR = NOT(XOR)   = AND + NOR
    A*NOT(B)          = OR * NOT(B)          (needed for A - B)

Addition     (operands A, B):        SUM = XOR ^ Cin,  COUT = AND + Cin*XOR
Subtraction  (operands A, NOT(B)):   SUM = XNOR ^ Cin, COUT = A*NOT(B) + Cin*XNOR
with C_IN(0) = SELECT (two's complement: A - B = A + NOT(B) + 1).

An n-bit operation uses n+1 modules; the (n+1)-th handles overflow with
sign-extended inputs (paper Sec. III-B). Comparison comes for free from the
subtraction output: the MSB (sign) of the (n+1)-bit result gives A<B, and a
near-memory AND tree over the complemented SUM bits detects A==B.

Everything operates on integer 0/1 tensors of any shape (vectorized across
columns/words exactly like the physical array computes all columns at once).
The reference's `lax.scan` over bit positions is a Python loop here with the
carry in a tensor; the per-position slices are taken along a leading axis, so
bits laid out plane-major and passed as a transposed view are read as
contiguous rows.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class ModuleOut(NamedTuple):
    sum_: torch.Tensor
    carry: torch.Tensor


def compute_module(or_, and_, b, c_in, select) -> ModuleOut:
    """One ADRA compute module (per bit, per column). All args are 0/1 ints.

    select = 0 -> addition, 1 -> subtraction (A - B).
    """
    xor = or_ & (1 - and_)
    xnor = 1 - xor
    a_not_b = or_ & (1 - b)

    # 2:1 muxes controlled by SELECT (Fig. 3(d))
    sel = torch.as_tensor(select, device=xor.device) == 1
    half = torch.where(sel, xnor, xor)           # A ^ B~  vs  A ^ B
    gen = torch.where(sel, a_not_b, and_)        # A*~B    vs  A*B

    sum_ = half ^ c_in
    carry = gen | (c_in & half)
    return ModuleOut(sum_=sum_, carry=carry)


def _positions(or_bits, and_bits, b_bits):
    """The n+1 module inputs, bit axis first: the (n+1)-th module reads the
    sign-extended inputs (bit n-1 replicated)."""
    xs = [torch.movedim(x, -1, 0) for x in (or_bits, and_bits, b_bits)]
    n = xs[0].shape[0]
    for i in range(n + 1):
        j = min(i, n - 1)
        yield xs[0][j], xs[1][j], xs[2][j]


def ripple_chain(or_bits: torch.Tensor, and_bits: torch.Tensor,
                 b_bits: torch.Tensor, select: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chain n+1 compute modules over the bit axis (axis -1, LSB first).

    Inputs are the per-bit SA outputs of an n-bit word pair, shape [..., n].
    Returns (sum_bits [..., n+1], carry_out [...]). The (n+1)-th module uses
    sign-extended inputs (bit n-1 replicated), handling two's-complement
    overflow exactly as the paper prescribes.
    """
    sel = torch.as_tensor(select, dtype=or_bits.dtype, device=or_bits.device)
    # the ripple is sequential in hardware too
    c = sel.expand(or_bits.shape[:-1])
    sums = []
    for o, a, bb in _positions(or_bits, and_bits, b_bits):
        out = compute_module(o, a, bb, c, sel)
        c = out.carry
        sums.append(out.sum_)
    return torch.movedim(torch.stack(sums), 0, -1), c


class CompareOut(NamedTuple):
    lt: torch.Tensor   # A < B   (sign bit of the (n+1)-bit A-B)
    eq: torch.Tensor   # A == B  (AND tree over complemented SUM bits)
    gt: torch.Tensor   # derived: NOT(lt) AND NOT(eq)


def and_tree_zero_detect(sum_bits: torch.Tensor) -> torch.Tensor:
    """Near-memory AND-gate tree: 1 iff every SUM bit is 0 (n-1 two-input
    AND gates for an n-bit word -> one gate per memory column of overhead)."""
    return torch.amin(1 - sum_bits, dim=-1)


def compare_from_sub(sum_bits: torch.Tensor) -> CompareOut:
    """Comparison from the subtraction output (paper Sec. III-B)."""
    lt = sum_bits[..., -1]                      # sign of A - B in 2's complement
    eq = and_tree_zero_detect(sum_bits)
    gt = (1 - lt) & (1 - eq)
    return CompareOut(lt=lt, eq=eq, gt=gt)


# ------------------------------------------------------------------
# Gate-count accounting (used by the energy model's peripheral terms)
# ------------------------------------------------------------------

#: extra transistors vs the prior-work adder-only module (paper Sec. III-B):
#: two 2:1 muxes + one NOT + one NOR. The alternate design trades the muxes
#: for a duplicated XOR + AOI21 (4 extra transistors, same-cycle add AND sub).
EXTRA_GATES_MUX_DESIGN = {"mux2": 2, "not": 1, "nor": 1}
EXTRA_TRANSISTORS_MUX_DESIGN = 2 * 6 + 2 + 4            # ~20
EXTRA_TRANSISTORS_DUAL_OUTPUT_DESIGN = EXTRA_TRANSISTORS_MUX_DESIGN + 4


# ------------------------------------------------------------------
# Alternate compute-module design (paper Sec. III-B, last paragraph):
# instead of the two 2:1 muxes, duplicate the XOR and AOI21 gates to
# produce the ADDITION and SUBTRACTION outputs in the SAME cycle
# (4 extra transistors vs the mux design).
# ------------------------------------------------------------------


class DualModuleOut(NamedTuple):
    sum_add: torch.Tensor
    carry_add: torch.Tensor
    sum_sub: torch.Tensor
    carry_sub: torch.Tensor


def compute_module_dual(or_, and_, b, c_in_add, c_in_sub) -> DualModuleOut:
    """One dual-output module: both A+B and A-B bits per cycle."""
    xor = or_ & (1 - and_)
    xnor = 1 - xor
    a_not_b = or_ & (1 - b)
    return DualModuleOut(
        sum_add=xor ^ c_in_add,
        carry_add=and_ | (c_in_add & xor),
        sum_sub=xnor ^ c_in_sub,
        carry_sub=a_not_b | (c_in_sub & xnor),
    )


def ripple_chain_dual(or_bits: torch.Tensor, and_bits: torch.Tensor,
                      b_bits: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """n+1 dual modules: (sum_add_bits [...,n+1], sum_sub_bits [...,n+1])
    from ONE memory access — the same-cycle add+sub capability."""
    ca = torch.zeros(or_bits.shape[:-1], dtype=or_bits.dtype,
                     device=or_bits.device)
    cs = torch.ones_like(ca)
    sa, ss = [], []
    for o, a, bb in _positions(or_bits, and_bits, b_bits):
        out = compute_module_dual(o, a, bb, ca, cs)
        ca, cs = out.carry_add, out.carry_sub
        sa.append(out.sum_add)
        ss.append(out.sum_sub)
    return (torch.movedim(torch.stack(sa), 0, -1),
            torch.movedim(torch.stack(ss), 0, -1))
