"""Public entry points of the kernels — port of `repro.kernels.ops`: the
ADRA integer ops and macros through the CiM engine, attention and the
recurrences (RG-LRU, and sLSTM, which the reference reaches through
`repro.kernels.slstm.slstm_scan`). The reference picks Pallas or its jnp
oracle by a flag; here the tensor's device decides: CPU and meta tensors
take the plain version (`repro_torch.PLAIN_DEVICES`: meta for the dry
run), CUDA tensors the kernel (which raises on what it does not take).
There is no switch and no fallback.

The ADRA wrappers take `backend=` (a `repro_torch.cim.backends` name; the
registry default when None). The reference's `interpret` flag names the
Pallas interpreter, which has no counterpart here: `interpret=True`
raises, `interpret=False` pins the compiled kernel ("fused").

`attention` is differentiable: its forward saves (q, k, v, o, lse) and its
backward is the blockwise FlashAttention-2 recomputation
(`repro_torch.models.blockwise_attention._bwd`, plain PyTorch; the
reference has no backward kernel either). `p = exp(s - lse)` there reads
the forward's log-sum-exp, so lse is part of the kernel's contract.
`rglru_scan` and `slstm_scan` are differentiable the same way: the
kernel's forward, and a backward that reruns the plain version under
autograd (the reference differentiates its jnp scans).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import takes_plain
from repro_torch.cim import PlanePack, execute, execute_unfused, macro
from repro_torch.cim.array import ArraySpec
from repro_torch.cim.dispatch import execute_tiled
from repro_torch.cim.planepack import mask_to_ints

from . import ref
from .adra_bitplane import (_no_interpret, adra_bitplane_op,  # noqa: F401
                            baseline_bitplane_sub_then_cmp)
from .flash_attention import flash_attention
from .rglru import rglru
from .slstm import slstm


#: kv block of the backward's recomputation (the reference's blockwise size)
BWD_BLOCK_K = 512


def _resolve_backend(interpret: Optional[bool],
                     backend: Optional[str]) -> Optional[str]:
    """An explicit backend wins; interpret=False pins the compiled kernel;
    interpret=True raises (see the module note); None/None defers to the
    registry default."""
    _no_interpret(interpret)
    if backend is not None:
        return backend
    return None if interpret is None else "fused"


# ---------------------------------------------------------------------------
# ADRA integer ops through the CiM engine
# ---------------------------------------------------------------------------


def adra_sub(a: torch.Tensor, b: torch.Tensor, n_bits: int = 16,
             interpret: Optional[bool] = None, backend: Optional[str] = None,
             spec: Optional[ArraySpec] = None, mesh=None):
    """Fused single-pass subtraction + comparison over integer tensors:
    (diff, lt, eq) as int32, from ONE access (one kernel launch on CUDA
    tensors). With `spec` the operands are tiled over the banked array:
    the same results, the ledger charged per bank activation."""
    bk = _resolve_backend(interpret, backend)
    pa, pb = PlanePack.pack(a, n_bits), PlanePack.pack(b, n_bits)
    if spec is not None or mesh is not None:
        out = execute_tiled(pa, pb, ("sub", "lt", "eq"), spec=spec,
                            backend=bk, mesh=mesh)
    else:
        out = execute(pa, pb, ("sub", "lt", "eq"), backend=bk)
    return out["sub"].unpack(), out["lt"].unpack(), out["eq"].unpack()


def adra_add(a: torch.Tensor, b: torch.Tensor, n_bits: int = 16,
             interpret: Optional[bool] = None, backend: Optional[str] = None,
             spec: Optional[ArraySpec] = None, mesh=None) -> torch.Tensor:
    """a + b in one access (int32), tiled over banks with `spec`."""
    bk = _resolve_backend(interpret, backend)
    pa, pb = PlanePack.pack(a, n_bits), PlanePack.pack(b, n_bits)
    if spec is not None or mesh is not None:
        out = execute_tiled(pa, pb, ("add",), spec=spec, backend=bk,
                            mesh=mesh)
    else:
        out = execute(pa, pb, ("add",), backend=bk)
    return out["add"].unpack()


def unpack_bits_mask(bitmap: torch.Tensor, n: int) -> torch.Tensor:
    """[1, W] bitmap -> int32[n] of 0/1 (see planepack.mask_to_ints)."""
    return mask_to_ints(bitmap, (n,))


def baseline_sub_then_cmp(a: torch.Tensor, b: torch.Tensor, n_bits: int = 16,
                          interpret: Optional[bool] = None,
                          backend: Optional[str] = None):
    """The paper's near-memory baseline: a subtraction access, then a
    comparison access that re-streams both operands (two launches)."""
    bk = _resolve_backend(interpret, backend)
    out = execute_unfused(PlanePack.pack(a, n_bits), PlanePack.pack(b, n_bits),
                          (("sub",), ("lt", "eq")), backend=bk)
    return out["sub"].unpack(), out["lt"].unpack(), out["eq"].unpack()


# ---------------------------------------------------------------------------
# macro ops (multi-access schedules from the CiM planner)
# ---------------------------------------------------------------------------


def cim_matmul(a: torch.Tensor, b: torch.Tensor, n_bits: int = 8,
               interpret: Optional[bool] = None,
               backend: Optional[str] = None,
               spec: Optional[ArraySpec] = None, mesh=None) -> torch.Tensor:
    """Exact intN x intN -> int32 matmul as one planned access schedule:
    (2 n_bits - 1) + ceil(log2 K) logical accesses, one dispatch; placed
    per bank on a banked `spec` (its tiles spread over `mesh`)."""
    return macro.matmul(a, b, n_bits=n_bits,
                        backend=_resolve_backend(interpret, backend),
                        spec=spec, mesh=mesh)


def cim_relu(x: torch.Tensor, n_bits: int = 16,
             interpret: Optional[bool] = None, backend: Optional[str] = None,
             spec: Optional[ArraySpec] = None, mesh=None) -> torch.Tensor:
    """max(x, 0) over integer tensors: one access (the gt predicate gates
    the writeback) whatever the width."""
    return macro.relu(PlanePack.pack(x, n_bits),
                      backend=_resolve_backend(interpret, backend),
                      spec=spec, mesh=mesh).unpack()


def cim_lower(fn, interpret: Optional[bool] = None,
              backend: Optional[str] = None,
              spec: Optional[ArraySpec] = None, mesh=None):
    """Compile an unmodified PyTorch function into the hybrid CiM/host
    callable (`repro_torch.cim.lower.lower`), with the backend resolved as
    the other wrappers here resolve it."""
    from repro_torch.cim.lower import lower

    return lower(fn, backend=_resolve_backend(interpret, backend),
                 spec=spec, mesh=mesh)


class _Attention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if takes_plain(q):
            o, lse = ref.mha_ref(q, k, v, causal=causal)
        else:
            o, lse = flash_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        from repro_torch.models.blockwise_attention import _bwd
        q, k, v, o, lse = ctx.saved_tensors
        b, tq, hq, _ = q.shape
        hkv = k.shape[2]
        lse_g = lse.reshape(b, hkv, hq // hkv, tq)      # q head = kv * G + g
        dq, dk, dv = _bwd(ctx.causal, None, 0, BWD_BLOCK_K,
                          (q, k, v, o, lse_g), do)
        return dq, dk, dv, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """GQA attention, q [B, Tq, Hq, D] over k, v [B, Tk, Hkv, D], scale
    1/sqrt(D): o [B, Tq, Hq, D] in q's dtype. CPU and meta tensors take
    `mha_ref` (`repro_torch.takes_plain`), CUDA tensors the flash kernel
    `flash_attention.route` picks (one launch per forward)."""
    return _Attention.apply(q, k, v, causal)


def _replay(plain, inputs, grads_out, needs):
    """The gradients of `plain(*inputs)` (a recurrence's plain version,
    its outputs flattened to a tuple) with respect to the inputs that
    `needs` marks, given the output gradients: the plain version rerun
    under autograd. Unmarked inputs get None."""
    with torch.enable_grad():
        ins = [None if t is None else t.detach().requires_grad_(bool(need))
               for t, need in zip(inputs, needs)]
        outs = plain(*ins)
        wrt = [t for t in ins if t is not None and t.requires_grad]
        pairs = [(o, g) for o, g in zip(outs, grads_out)
                 if g is not None and o.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       allow_unused=True))
    return tuple(next(got) if t is not None and t.requires_grad else None
                 for t in ins)


class _RGLRU(torch.autograd.Function):
    """The RG-LRU kernel's forward; its backward reruns `rglru_ref` (the
    same function) under autograd, as the reference differentiates its
    jnp scan: there is no backward kernel."""

    @staticmethod
    def forward(ctx, x, r, i, log_lambda, h0, c):
        ctx.save_for_backward(x, r, i, log_lambda, h0)
        ctx.c = c
        return rglru(x, r, i, log_lambda, h0=h0, c=c)

    @staticmethod
    def backward(ctx, dy, dh):
        c = ctx.c
        return _replay(lambda x, r, i, ll, h0: ref.rglru_ref(
            x, r, i, ll, h0=h0, c=c), ctx.saved_tensors, (dy, dh),
            ctx.needs_input_grad[:5]) + (None,)


class _SLSTM(torch.autograd.Function):
    """The sLSTM kernel's forward; its backward reruns `slstm_ref` under
    autograd, as `_RGLRU`'s."""

    @staticmethod
    def forward(ctx, wx, r_gates, b_gates, h0, c0, n0, m0):
        ctx.save_for_backward(wx, r_gates, b_gates, h0, c0, n0, m0)
        y, state = slstm(wx, r_gates, b_gates, h0, c0, n0, m0)
        return (y, *state)

    @staticmethod
    def backward(ctx, *grads):
        def plain(*ins):
            y, state = ref.slstm_ref(*ins)
            return (y, *state)
        return _replay(plain, ctx.saved_tensors, grads,
                       ctx.needs_input_grad)


def rglru_scan(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
               log_lambda: torch.Tensor, h0: Optional[torch.Tensor] = None,
               c: float = 8.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU over [B, T, D]: returns (y in x's dtype, h_T in float32).
    CPU and meta tensors take `rglru_ref`, CUDA tensors the kernel `rglru.route`
    picks (one launch), differentiable through `_RGLRU`."""
    if takes_plain(x):
        return ref.rglru_ref(x, r, i, log_lambda, h0=h0, c=c)
    return _RGLRU.apply(x, r, i, log_lambda, h0, c)


def slstm_scan(wx: torch.Tensor, r_gates: torch.Tensor, b_gates: torch.Tensor,
               h0: torch.Tensor, c0: torch.Tensor, n0: torch.Tensor,
               m0: torch.Tensor):
    """sLSTM over wx [B, T, 4, D]: returns (y [B, T, D] in wx's dtype,
    (h, c, n, m) [B, D] in float32). CPU and meta tensors take `slstm_ref`,
    CUDA tensors the kernel `slstm.route` picks (one launch),
    differentiable through `_SLSTM`."""
    if takes_plain(wx):
        return ref.slstm_ref(wx, r_gates, b_gates, h0, c0, n0, m0)
    y, *state = _SLSTM.apply(wx, r_gates, b_gates, h0, c0, n0, m0)
    return y, tuple(state)
