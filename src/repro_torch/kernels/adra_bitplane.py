"""Legacy entry points of the ADRA bit-plane kernel (compatibility shims).

Port of `repro.kernels.adra_bitplane`. The kernel itself is the fused
bit-plane kernel (`repro_torch.cim.fused_kernel.fused_planes_op`, CUDA for
CUDA tensors): one pass that emits any subset of add, sub, carries,
lt/eq/gt and the 16 Boolean plane stacks. These wrappers keep the original
select-based call contract over it; new code goes through
`repro_torch.cim.engine` or `fused_planes_op` directly. There is no
interpret mode: `interpret=True` raises.
"""
from __future__ import annotations

import functools
import operator

import torch

from repro_torch.cim.engine import traffic_model_bytes as _traffic_model
from repro_torch.cim.fused_kernel import fused_planes_op
from repro_torch.cim.opset import CimOpError


def _no_interpret(interpret: bool) -> None:
    if interpret:
        raise CimOpError("interpret=True names the Pallas interpreter, which "
                         "the port has no counterpart of: CPU tensors take "
                         "the plain version, CUDA tensors the kernel")


def adra_bitplane_op(a_planes: torch.Tensor, b_planes: torch.Tensor,
                     select: int, interpret: bool = False):
    """Single-pass fused bit-plane add (select=0) / sub (select=1).

    Returns (sum_planes [n_bits+1, W], carry [1, W], lt [1, W],
    eq [1, W]). lt/eq are per-column bitmaps (for select=0 they are the
    legacy sign/zero bitmaps of the add chain). One kernel launch."""
    _no_interpret(interpret)
    if select == 1:
        return fused_planes_op(a_planes, b_planes,
                               ("sub", "carry_sub", "lt", "eq"))
    sum_p, carry = fused_planes_op(a_planes, b_planes, ("add", "carry_add"))
    # legacy select=0 contract: sign/zero detect over the add output planes
    nz = functools.reduce(operator.or_,
                          [sum_p[i] for i in range(sum_p.shape[0])])
    return sum_p, carry, sum_p[-1:, :], (~nz)[None, :]


def baseline_bitplane_sub_then_cmp(a_planes: torch.Tensor,
                                   b_planes: torch.Tensor,
                                   interpret: bool = False):
    """Near-memory baseline: a subtraction pass, then a separate comparison
    pass that re-reads both operands (the paper's second access). Two
    kernel launches."""
    _no_interpret(interpret)
    (sum_p,) = fused_planes_op(a_planes, b_planes, ("sub",))
    lt, eq = fused_planes_op(a_planes, b_planes, ("lt", "eq"))
    return sum_p, lt, eq


def traffic_model_bytes(n_bits: int, n_words32: int) -> dict:
    """Device-memory bytes of the fused pass against the two-pass baseline
    (sub + carry + compare fused, vs a sub pass then a compare pass)."""
    return _traffic_model(
        n_bits, n_words32, ops=("sub", "carry_sub", "lt", "eq"),
        baseline_passes=(("sub",), ("lt", "eq")))
