"""Blockwise (FlashAttention-2 style) attention in plain PyTorch, with a
custom backward, so neither pass materializes the Tq x Tk score matrix.

Port of `repro.models.blockwise_attention`'s float part (`_mask`,
`_pad_kv`, `_fwd`, `_bwd`) on the same block layout [B, Hkv, G, Tq, bk]:

  fwd : loop over kv blocks, carry (m, l, acc); save (q, k, v, o, lse)
  bwd : recomputation — delta = rowsum(dO * O), one loop over kv blocks
        accumulating dq and emitting (dk_j, dv_j) per block.

GQA (q heads grouped over kv heads), causal masking with end-aligned query
positions and an optional local window. The reference's `jax.custom_vjp`
is the `torch.autograd.Function` `BlockwiseAttention`; `lax.scan` is a
Python loop. `_bwd` is also the backward of `kernels.ops.attention`, whose
forward is the CUDA flash kernel on the card. Inputs in float64 compute in
float64 (for `torch.autograd.gradcheck`); anything else in float32, as the
reference.

`blockwise_attention_quantized` is the forward-only int8 form with a
pluggable batched matmul, and `blockwise_attention_cim` runs its two
contractions per kv block through one `lower()`ed quantized batched
matmul: fixed block shapes, so two programs serve every block.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch
import torch.nn.functional as F

NEG = -1e30


def _mask(tq: int, tk: int, kj0: int, bq: int, bk: int, causal: bool,
          window: int, device=None) -> torch.Tensor:
    """[bq, bk] bool for q rows 0..tq and kv cols kj0.. (end-aligned causal)."""
    q_pos = torch.arange(bq, device=device)[:, None] + (tk - tq)
    k_pos = kj0 + torch.arange(bk, device=device)[None, :]
    m = k_pos < tk
    if causal:
        m = m & (q_pos >= k_pos)
    if window:
        m = m & (q_pos - k_pos < window)
    return m


def _pad_kv(k: torch.Tensor, v: torch.Tensor, bk: int):
    pad = (-k.shape[1]) % bk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    return k, v


def _setup(q, k, v, scale, block_k):
    """Shared by both passes: shapes, compute dtype, the kv block size and
    the padded kv split into blocks [B, nk, bk, Hkv, D]."""
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    scale_v = scale if scale is not None else 1.0 / d ** 0.5
    dt = torch.float64 if q.dtype == torch.float64 else torch.float32
    bk = min(block_k, tk) if tk % min(block_k, tk) == 0 else block_k
    kp, vp = _pad_kv(k, v, bk)
    nk = kp.shape[1] // bk
    ks = kp.to(dt).reshape(b, nk, bk, hkv, d)
    vs = vp.to(dt).reshape(b, nk, bk, hkv, dv)
    qg = (q.to(dt) * scale_v).reshape(b, tq, hkv, g, d)
    return (b, tq, hq, d, tk, hkv, dv, g, scale_v, dt, bk, nk), qg, ks, vs


def _fwd(q, k, v, causal, scale, window, block_k):
    """Returns (o [B, Tq, Hq, Dv] in q's dtype, lse [B, Hkv, G, Tq])."""
    (b, tq, hq, _, tk, hkv, dv, g, _, dt, bk, nk), qg, ks, vs = \
        _setup(q, k, v, scale, block_k)
    dev = q.device
    neg = torch.tensor(NEG, dtype=dt, device=dev)
    m_run = torch.full((b, hkv, g, tq), NEG, dtype=dt, device=dev)
    l_run = torch.zeros((b, hkv, g, tq), dtype=dt, device=dev)
    acc = torch.zeros((b, hkv, g, tq, dv), dtype=dt, device=dev)
    for j in range(nk):
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ks[:, j])
        msk = _mask(tq, tk, j * bk, tq, bk, causal, window, dev)
        s = torch.where(msk, s, neg)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_run - m_new)
        l_run = alpha * l_run + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                    vs[:, j])
        m_run = m_new
    safe_l = torch.where(l_run == 0.0, torch.ones_like(l_run), l_run)
    o = acc / safe_l[..., None]                              # [B,Hkv,G,Tq,D]
    o = o.permute(0, 3, 1, 2, 4).reshape(b, tq, hq, dv).to(q.dtype)
    lse = m_run + torch.log(safe_l)                          # [B,Hkv,G,Tq]
    return o, lse


def _bwd(causal, scale, window, block_k, res, do):
    """FlashAttention-2 backward from the saved (q, k, v, o, lse [B, Hkv,
    G, Tq]): returns (dq, dk, dv) in the dtypes of q, k, v."""
    q, k, v, o, lse = res
    (b, tq, hq, d, tk, hkv, dv, g, scale_v, dt, bk, nk), qg, ks, vs = \
        _setup(q, k, v, scale, block_k)
    dev = q.device
    neg = torch.tensor(NEG, dtype=dt, device=dev)
    dog = do.to(dt).reshape(b, tq, hkv, g, dv)
    og = o.to(dt).reshape(b, tq, hkv, g, dv)
    delta = torch.einsum("bqhgd,bqhgd->bhgq", dog, og)       # [B,Hkv,G,Tq]
    lse = lse.to(dt)
    dq = torch.zeros((b, tq, hkv, g, d), dtype=dt, device=dev)
    dks, dvs = [], []
    for j in range(nk):
        kb, vb = ks[:, j], vs[:, j]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb)
        msk = _mask(tq, tk, j * bk, tq, bk, causal, window, dev)
        s = torch.where(msk, s, neg)
        p = torch.exp(s - lse[..., None])                    # [B,Hkv,G,Tq,bk]
        dvs.append(torch.einsum("bhgqk,bqhgd->bkhd", p, dog))
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vb)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", ds, kb)
        dks.append(torch.einsum("bhgqk,bqhgd->bkhd", ds, qg))
    dq = (dq * scale_v).reshape(b, tq, hq, d).to(q.dtype)
    dk = torch.cat(dks, dim=1)[:, :tk].to(k.dtype)
    dv_out = torch.cat(dvs, dim=1)[:, :tk].to(v.dtype)
    return dq, dk, dv_out


class BlockwiseAttention(torch.autograd.Function):
    """The reference's `custom_vjp`: forward `_fwd`, backward `_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, block_k):
        o, lse = _fwd(q, k, v, causal, scale, window, block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, window, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = _bwd(*ctx.args, ctx.saved_tensors, do)
        return dq, dk, dv, None, None, None, None


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None,
                        window: int = 0, block_k: int = 512) -> torch.Tensor:
    """q [B, Tq, Hq, D], k and v [B, Tk, Hkv, D] -> o [B, Tq, Hq, D] in
    q's dtype, differentiable through `_bwd`."""
    return BlockwiseAttention.apply(q, k, v, causal, scale, window, block_k)


# ---------------------------------------------------------------------------
# Quantized blockwise attention (host reference + CiM-lowered execution)
# ---------------------------------------------------------------------------

#: bounded LRU of lowered quantized batched matmuls (see
#: layers._LOWERED_LINEAR)
_LOWERED_BMM: "OrderedDict" = OrderedDict()


def blockwise_attention_quantized(q, k, v, causal=True, scale=None, window=0,
                                  block_k=512, n_bits=8, bmm=None):
    """Forward-only quantized blockwise attention with a pluggable batched
    matmul.

    The online-softmax recurrence of `_fwd`, but the per-block QK^T and AV
    contractions go through `bmm(a, b)` on canonical [B*, M, K] x
    [B*, K, N] operands: `quantized_batched_matmul` when `bmm` is None (the
    float-quantized host reference), or a `lower()`ed twin of it
    (`blockwise_attention_cim`). The kv loop runs over FIXED block shapes,
    so every block presents the same two operand signatures."""
    from .layers import quantized_batched_matmul

    if bmm is None:
        def bmm(a, bb):
            return quantized_batched_matmul(a, bb, n_bits)
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    scale_v = scale if scale is not None else 1.0 / d ** 0.5
    bk = min(block_k, tk) if tk % min(block_k, tk) == 0 else block_k
    kp, vp = _pad_kv(k, v, bk)
    nk = kp.shape[1] // bk
    dev = q.device

    qm = (q.float() * scale_v).reshape(b, tq, hkv, g, d) \
        .permute(0, 2, 3, 1, 4).reshape(b, hkv, g * tq, d)
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    m_run = torch.full((b, hkv, g, tq), NEG, dtype=torch.float32, device=dev)
    l_run = torch.zeros((b, hkv, g, tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, tq, dv), dtype=torch.float32, device=dev)
    for j in range(nk):
        kb = kp[:, j * bk:(j + 1) * bk].float()               # [B,bk,Hkv,D]
        vb = vp[:, j * bk:(j + 1) * bk].float()
        s = bmm(qm, kb.permute(0, 2, 3, 1)) \
            .reshape(b, hkv, g, tq, bk)                      # [B,Hkv,G,Tq,bk]
        msk = _mask(tq, tk, j * bk, tq, bk, causal, window, dev)
        s = torch.where(msk, s, neg)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_run - m_new)
        l_run = alpha * l_run + p.sum(dim=-1)
        pv = bmm(p.reshape(b, hkv, g * tq, bk),
                 vb.permute(0, 2, 1, 3)).reshape(b, hkv, g, tq, dv)
        acc = acc * alpha[..., None] + pv
        m_run = m_new
    safe_l = torch.where(l_run == 0.0, torch.ones_like(l_run), l_run)
    o = acc / safe_l[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, tq, hq, dv).to(q.dtype)


def blockwise_attention_cim(q, k, v, causal=True, scale=None, window=0,
                            block_k=512, n_bits=8, backend=None, spec=None,
                            resident=False):
    """Blockwise attention whose integer contractions execute in the CiM
    array: bit-exact with `blockwise_attention_quantized` on the same
    operands, 2 dispatches per kv block, and (by the structural region key)
    ONE program per contraction shape shared across all blocks."""
    from .layers import _lru_get, quantized_batched_matmul

    def make():
        from repro_torch.cim import array
        from repro_torch.cim.lower import lower

        return lower(lambda a, bb: quantized_batched_matmul(a, bb, n_bits),
                     backend=backend, spec=spec,
                     resident_argnums=(1,) if resident else (),
                     resident_set=array.resident_set(spec)
                     if resident else None)

    bmm = _lru_get(_LOWERED_BMM, (n_bits, backend, spec, resident), make)
    return blockwise_attention_quantized(q, k, v, causal, scale, window,
                                         block_k, n_bits, bmm=bmm)
