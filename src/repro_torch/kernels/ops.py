"""Public entry points of the kernels — port of `repro.kernels.ops` for
attention and the recurrences (RG-LRU, and sLSTM, which the reference
reaches through `repro.kernels.slstm.slstm_scan`). The reference picks
Pallas or its jnp oracle by a flag; here the tensor's device decides: CPU
tensors take the plain version, CUDA tensors the kernel (which raises on
what it does not take). There is no switch and no fallback.

`attention` is differentiable: its forward saves (q, k, v, o, lse) and its
backward is the blockwise FlashAttention-2 recomputation
(`repro_torch.models.blockwise_attention._bwd`, plain PyTorch; the
reference has no backward kernel either). `p = exp(s - lse)` there reads
the forward's log-sum-exp, so lse is part of the kernel's contract.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import ref
from .flash_attention import flash_attention
from .rglru import rglru
from .slstm import slstm


#: kv block of the backward's recomputation (the reference's blockwise size)
BWD_BLOCK_K = 512


class _Attention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type == "cpu":
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
    1/sqrt(D): o [B, Tq, Hq, D] in q's dtype. CPU tensors take `mha_ref`,
    CUDA tensors the flash kernel `flash_attention.route` picks (one launch
    per forward)."""
    return _Attention.apply(q, k, v, causal)


def rglru_scan(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
               log_lambda: torch.Tensor, h0: Optional[torch.Tensor] = None,
               c: float = 8.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU over [B, T, D]: returns (y in x's dtype, h_T in float32).
    CPU tensors take `rglru_ref`, CUDA tensors the kernel `rglru.route`
    picks (one launch)."""
    if x.device.type == "cpu":
        return ref.rglru_ref(x, r, i, log_lambda, h0=h0, c=c)
    return rglru(x, r, i, log_lambda, h0=h0, c=c)


def slstm_scan(wx: torch.Tensor, r_gates: torch.Tensor, b_gates: torch.Tensor,
               h0: torch.Tensor, c0: torch.Tensor, n0: torch.Tensor,
               m0: torch.Tensor):
    """sLSTM over wx [B, T, 4, D]: returns (y [B, T, D] in wx's dtype,
    (h, c, n, m) [B, D] in float32). CPU tensors take `slstm_ref`, CUDA
    tensors the kernel `slstm.route` picks (one launch)."""
    if wx.device.type == "cpu":
        return ref.slstm_ref(wx, r_gates, b_gates, h0, c0, n0, m0)
    return slstm(wx, r_gates, b_gates, h0, c0, n0, m0)
