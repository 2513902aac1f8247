"""Shared model layers: norms, rotary embeddings, MLPs, embedding tables,
and the int8 CiM-quantized linear path.

Port of `repro.models.layers`. Plain functions over dicts of tensors;
initializers take an explicit `torch.Generator` and device. Matmul-bearing
layers compute in float32 and cast to the activation dtype, as the
reference's `preferred_element_type=float32` einsums do.

`mlp_cim` runs each integer contraction as a planned CiM schedule by
calling `repro_torch.cim.macro.matmul` directly. The reference stages the
same function through its jaxpr lowering compiler (`repro.cim.lower`); each
of its MLP regions holds exactly one integer `dot_general`, executed by the
same `_matmul_with` dataflow, so the accesses, dispatches and loads per
call are the same (the region's int32 entry packs are charged through
`entry_bits`). Porting the lowering compiler itself is later work.
`spec` is the banked geometry the contractions run on, as in the
reference: `spec=None` resolves through `array.spec_override()`, so it
means unbanked until a degraded spec is installed with `set_current_spec`.
Resident weights: `matmul_rhs_pack(wq, m, n_bits)` is pinned per weight
tensor and row count m, keyed by the identity of the weight tensor, when
its rows fit the resident budget — an oversize pack stays streamed, as the
reference's residency planning decides. The pins live in the registry
ResidentSet of `resident_spec` (the serve's widened array), else of the
banked spec, as the reference's lowered regions pin.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.cim import array as array_mod
from repro_torch.cim import macro

Params = Dict[str, torch.Tensor]


def _dense_init(gen: torch.Generator, shape, in_axis_size: int, dtype,
                device) -> torch.Tensor:
    """Normal(0, 1/in_axis_size) — the reference's initializer distribution
    (different random numbers: torch and jax generators differ)."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * (1.0 / float(in_axis_size) ** 0.5)).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm / rotary
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Interleaved (adjacent-pair) RoPE: x [B, T, H, D], positions [B, T]."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)
    angles = positions.unsqueeze(-1).float() * freqs          # [B, T, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xr = x.float().reshape(x.shape[:-1] + (d // 2, 2))
    x1, x2 = xr[..., 0], xr[..., 1]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / plain GELU)
# ---------------------------------------------------------------------------


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's does not
    return F.gelu(x, approximate="tanh")


def mlp_init(gen, d_model: int, d_ff: int, gating: str, dtype,
             device) -> Params:
    p = {"w_in": _dense_init(gen, (d_model, d_ff), d_model, dtype, device),
         "w_out": _dense_init(gen, (d_ff, d_model), d_ff, dtype, device)}
    if gating in ("swiglu", "geglu"):
        p["w_gate"] = _dense_init(gen, (d_model, d_ff), d_model, dtype, device)
    return p


def _linear_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.float(), w.float())


def mlp(p: Params, x: torch.Tensor, gating: str) -> torch.Tensor:
    h = _linear_f32(x, p["w_in"])
    if gating == "swiglu":
        h = F.silu(_linear_f32(x, p["w_gate"])) * h
    elif gating == "geglu":
        h = _gelu(_linear_f32(x, p["w_gate"])) * h
    else:
        h = _gelu(h)
    return _linear_f32(h.to(x.dtype), p["w_out"]).to(x.dtype)


# ---------------------------------------------------------------------------
# int8 quantized path: host twins and the CiM schedules
# ---------------------------------------------------------------------------


def _quant_scale(x: torch.Tensor, n_bits: int) -> torch.Tensor:
    qmax = float(2 ** (n_bits - 1) - 1)
    return torch.clamp(x.float().abs().max(), min=1e-8) / qmax


def quantize_symmetric(x: torch.Tensor, n_bits: int = 8):
    """Per-tensor symmetric quantization: x ~ q * scale, q in intN range
    (round half to even, as jnp.round)."""
    qmax = float(2 ** (n_bits - 1) - 1)
    scale = _quant_scale(x, n_bits)
    q = torch.clamp(torch.round(x.float() / scale), -qmax, qmax)
    return q.to(torch.int32), scale


def int_contract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer (batched) matmul of quantized operands -> int32.

    On the CPU in int32 (an int8 matmul would wrap, as the reference's
    `preferred_element_type=int32` avoids). CUDA has no integer matmul for
    these shapes, so there the contraction runs in float64, which is exact
    here: every partial sum is an integer below 2^53 (|q| <= 127, so
    127^2 * K < 2^53 for any K below 5e11)."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def _quantized_linear(x: torch.Tensor, w: torch.Tensor,
                      n_bits: int) -> torch.Tensor:
    """Host twin: fake-quantize both operands, contract EXACTLY in
    integers, rescale."""
    d, f = w.shape
    lead = tuple(x.shape[:-1])
    xq, sx = quantize_symmetric(x, n_bits)
    wq, sw = quantize_symmetric(w, n_bits)
    y = int_contract(xq.reshape(-1, d), wq)
    return (y.float() * (sx * sw)).reshape(lead + (f,))


def quantized_batched_matmul(a: torch.Tensor, b: torch.Tensor,
                             n_bits: int = 8) -> torch.Tensor:
    """Host twin: per-tensor-quantized [*B,M,K] x [*B,K,N] -> f32."""
    aq, sa = quantize_symmetric(a, n_bits)
    bq, sb = quantize_symmetric(b, n_bits)
    return int_contract(aq, bq).float() * (sa * sb)


def cim_batched_matmul(a: torch.Tensor, b: torch.Tensor, n_bits: int = 8,
                       backend: Optional[str] = None,
                       spec: Optional[array_mod.ArraySpec] = None
                       ) -> torch.Tensor:
    """`quantized_batched_matmul` with its integer contraction run as a
    planned batched CiM schedule (one dispatch), banked on `spec` if given."""
    aq, sa = quantize_symmetric(a, n_bits)
    bq, sb = quantize_symmetric(b, n_bits)
    y = macro.batched_matmul(aq, bq, n_bits=n_bits, backend=backend,
                             spec=spec, entry_bits=32)
    return y.float() * (sa * sb)


def _mlp_quantized(p: Params, x: torch.Tensor, gating: str,
                   n_bits: int, linear=None) -> torch.Tensor:
    """The quantized MLP as one plain function — the host twin `mlp_cim`
    must match bit for bit (`linear` swaps in the CiM contraction)."""
    linear = linear or (lambda x_, w_: _quantized_linear(x_, w_, n_bits))
    h = linear(x, p["w_in"])
    if gating == "swiglu":
        h = F.silu(linear(x, p["w_gate"])) * h
    elif gating == "geglu":
        h = _gelu(linear(x, p["w_gate"])) * h
    else:
        h = _gelu(h)
    return linear(h, p["w_out"]).to(x.dtype)


def _resident_rhs(rs: array_mod.ResidentSet, w: torch.Tensor, m: int,
                  n_bits: int):
    """The pinned [M, K_pad, N] int8 plane stack of weight `w`, or None
    when it does not fit the resident budget (it then streams)."""
    k, n = (int(d) for d in w.shape)
    k_pad = 1 << macro.planner._log2_ceil(k)
    rows = rs._rows_for(n_bits, m * k_pad * n)
    if max(rows.values(), default=0) > rs.budget:
        return None
    key = ("mlp", id(w), m, n_bits)
    fp = (id(w),)
    entry = rs.get(key, fingerprint=fp)
    if entry is None:
        wq, _ = quantize_symmetric(w, n_bits)
        # aux keeps the weight alive so its id() cannot be recycled
        entry = rs.pin(key, macro.matmul_rhs_pack(wq, m, n_bits),
                       fingerprint=fp, aux=w)
    return entry.pack


def cim_linear(x: torch.Tensor, w: torch.Tensor, n_bits: int = 8,
               backend: Optional[str] = None,
               spec: Optional[array_mod.ArraySpec] = None,
               resident: bool = False,
               resident_spec: Optional[array_mod.ArraySpec] = None
               ) -> torch.Tensor:
    """x @ w through intN quantization with the integer contraction run as
    a planned CiM schedule: x [..., D], w [D, F] -> f32 [..., F], bit-exact
    with `_quantized_linear`, on the banked `spec` (see the module note on
    `spec=None`). With `resident` the int8 weight planes are pinned at
    first call and reused while `w` is the same tensor."""
    if spec is None:
        spec = array_mod.spec_override()
    d, f = (int(s) for s in w.shape)
    lead = tuple(x.shape[:-1])
    xq, sx = quantize_symmetric(x, n_bits)
    xq = xq.reshape(-1, d)
    pack = None
    if resident:
        rs = array_mod.resident_set(resident_spec or spec)
        pack = _resident_rhs(rs, w, xq.shape[0], n_bits)
    if pack is not None:
        sw = _quant_scale(w, n_bits)
        y = macro.matmul(xq, None, n_bits=n_bits, backend=backend, spec=spec,
                         b_pack=pack, entry_bits=32)
    else:
        wq, sw = quantize_symmetric(w, n_bits)
        y = macro.matmul(xq, wq, n_bits=n_bits, backend=backend, spec=spec,
                         entry_bits=32)
    return (y.float() * (sx * sw)).reshape(lead + (f,))


def mlp_cim(p: Params, x: torch.Tensor, gating: str, n_bits: int = 8,
            backend: Optional[str] = None,
            spec: Optional[array_mod.ArraySpec] = None,
            resident: bool = False,
            resident_spec: Optional[array_mod.ArraySpec] = None
            ) -> torch.Tensor:
    """The quantized MLP with every integer matmul in the CiM array on the
    banked `spec` (`spec=None`: `array.spec_override()`, so a degraded spec
    installed with `set_current_spec` re-routes here too) and every float
    op (scales, gating) on the host. `resident=True` pins the int8 weight
    planes in the registry ResidentSet of `resident_spec`, else of `spec`."""
    return _mlp_quantized(
        p, x, gating, n_bits,
        linear=lambda x_, w_: cim_linear(x_, w_, n_bits, backend, spec,
                                         resident, resident_spec))


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embed_init(gen, vocab: int, d_model: int, dtype, device) -> Params:
    return {"table": _dense_init(gen, (vocab, d_model), d_model, dtype, device)}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def lm_head_init(gen, d_model: int, vocab: int, dtype, device) -> Params:
    return {"w": _dense_init(gen, (d_model, vocab), d_model, dtype, device)}


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def chunked_lm_loss(x: torch.Tensor, w_head: torch.Tensor,
                    targets: torch.Tensor, real_vocab: int,
                    chunk: int = 512) -> torch.Tensor:
    """Mean CE over x [B, S, D] and targets [B, S] without materializing
    the [B, S, V] logits: sequence chunks of `chunk` tokens (the largest
    divisor of S not above it), each run under `torch.utils.checkpoint` (the
    reference's `jax.checkpoint`), so its logits are recomputed in the
    backward and peak memory is one chunk's logits. Padded vocab columns
    are masked to -1e30."""
    b, s, _ = x.shape
    v = w_head.shape[-1]
    c = chunk
    while s % c:
        c -= 1
    pad_mask = (torch.arange(v, device=x.device) >= real_vocab) * (-1e30)

    def body(xc, tc):
        logits = torch.matmul(xc.float(), w_head.float()) + pad_mask
        return torch.sum(cross_entropy(logits, tc))

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(s // c):
        total = total + checkpoint(body, x[:, i * c:(i + 1) * c],
                                   targets[:, i * c:(i + 1) * c],
                                   use_reentrant=False)
    return total / (b * s)


def cross_entropy(logits_f32: torch.Tensor,
                  targets: torch.Tensor) -> torch.Tensor:
    """Per-position CE, the target logit picked with an iota == target mask
    as the reference does. As there, the max is detached only inside the
    exponent and added back undetached, so the gradient carries an extra
    +1 at each row's argmax (ROADMAP C records it); the port keeps the
    reference's numbers."""
    v = logits_f32.shape[-1]
    m = torch.amax(logits_f32, dim=-1, keepdim=True)
    shifted = logits_f32 - m.detach()
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1)) + m[..., 0]
    onehot = torch.arange(v, device=logits_f32.device) == targets[..., None]
    tgt = torch.sum(torch.where(onehot, logits_f32,
                                torch.zeros((), dtype=logits_f32.dtype,
                                            device=logits_f32.device)),
                    dim=-1)
    return lse - tgt
