"""Shared model layers: norms, rotary embeddings, MLPs, embedding tables,
and the int8 CiM-quantized linear path.

Port of `repro.models.layers`. Plain functions over dicts of tensors;
initializers take an explicit `torch.Generator` and device. Matmul-bearing
layers compute in float32 and cast to the activation dtype, as the
reference's `preferred_element_type=float32` einsums do.

`mlp_cim` and `cim_linear` are `lower()` applications, as in the reference:
the quantized function is captured once per argument signature
(`repro_torch.cim.lower`), its integer contractions (`int_contract` in the
narrow dtype `_cim_int_dtype` picks, int32 result) run as fused CiM regions
and the float quantize/rescale/gating ops on the host. `spec` is the banked
geometry the regions run on: `spec=None` resolves through
`array.spec_override()`, so it means unbanked until a degraded spec is
installed with `set_current_spec`. With `resident=True` the weight-side
region inputs are pinned by the lowering's residency planning, in the
registry ResidentSet of `resident_spec` (the serve's widened array) when one
is given, else of the banked spec.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.cim import array as array_mod
from repro_torch.cim.trace import int_contract
from repro_torch.sharding import rules

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


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               width: Optional[int] = None, offset: int = 0) -> torch.Tensor:
    """Interleaved (adjacent-pair) RoPE: x [B, T, H, D], positions [B, T].
    With `width`, x holds features offset..offset+D of a `width`-wide head
    (a tensor-parallel rank's block of head_dim; `offset` even)."""
    d = x.shape[-1]
    freqs = rope_frequencies(width or d, theta, x.device)
    freqs = freqs[offset // 2:offset // 2 + d // 2]
    angles = positions.unsqueeze(-1).float() * freqs          # [B, T, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xr = x.float().reshape(x.shape[:-1] + (d // 2, 2))
    x1, x2 = xr[..., 0], xr[..., 1]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.reshape(x.shape).to(x.dtype)


def hint_batch_sharding(x: torch.Tensor) -> torch.Tensor:
    """Sharding hint: leading (batch) dim on the DP axes. A DTensor
    activation is redistributed to that layout when a mesh is in scope
    (`repro_torch.sharding.use_mesh`); anything else passes through, as the
    reference's hint is a no-op without a mesh."""
    mesh = rules.current_mesh()
    if mesh is None or not rules.is_dtensor(x):
        return x
    return x.redistribute(mesh, rules.batch_placements(mesh))


def hint_activation_sharding(x: torch.Tensor) -> torch.Tensor:
    """Layer-boundary activation hint: batch on DP axes AND sequence on the
    model axis (sequence parallelism, Korthikanti et al.): the per-layer
    saved inputs of the remat stack are the dominant train-time residency
    (n_layers x [B, S, d]); 2-D sharding cuts them by the model-axis width.
    Falls back to batch-only for short sequences / decode steps (and for a
    sequence the model axis does not divide)."""
    mesh = rules.current_mesh()
    if mesh is None or not rules.is_dtensor(x):
        return x
    model = rules.axis_sizes(mesh).get("model", 1)
    if x.ndim >= 3 and x.shape[1] >= 64 and x.shape[1] % model == 0:
        return x.redistribute(mesh, rules.batch_placements(mesh, 1))
    return hint_batch_sharding(x)


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


def mlp(p: Params, x: torch.Tensor, gating: str,
        reduce=None) -> torch.Tensor:
    """The MLP; `reduce` (a tensor-parallel region's sum over ranks) is
    applied to the float32 output before the cast."""
    h = _linear_f32(x, p["w_in"])
    if gating == "swiglu":
        h = F.silu(_linear_f32(x, p["w_gate"])) * h
    elif gating == "geglu":
        h = _gelu(_linear_f32(x, p["w_gate"])) * h
    else:
        h = _gelu(h)
    y = _linear_f32(h.to(x.dtype), p["w_out"])
    return (y if reduce is None else reduce(y)).to(x.dtype)


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


def _cim_int_dtype(n_bits: int) -> torch.dtype:
    """Narrowest integer dtype holding symmetric n_bits quantized values:
    the dtype IS the eligibility signal the lowering compiler reads."""
    if n_bits <= 8:
        return torch.int8
    if n_bits <= 16:
        return torch.int16
    return torch.int32


def _quantized_linear(x: torch.Tensor, w: torch.Tensor,
                      n_bits: int) -> torch.Tensor:
    """Quantized linear: fake-quantize both operands, contract EXACTLY in
    narrow integers (int32 result), rescale. This is the function the
    lowering compiler captures: its `int_contract` is the CiM-eligible op;
    the float quantize/rescale stays on the host."""
    d, f = w.shape
    lead = tuple(x.shape[:-1])
    xq, sx = quantize_symmetric(x, n_bits)
    wq, sw = quantize_symmetric(w, n_bits)
    dt = _cim_int_dtype(n_bits)
    y = int_contract(xq.reshape(-1, d).to(dt), wq.to(dt))
    return (y.float() * (sx * sw)).reshape(lead + (f,))


def quantized_batched_matmul(a: torch.Tensor, b: torch.Tensor,
                             n_bits: int = 8) -> torch.Tensor:
    """Per-tensor-quantized batched matmul [*B,M,K] x [*B,K,N] -> f32, on
    the canonical batched contraction the planner lowers with a per-tile
    access count independent of the batch size."""
    aq, sa = quantize_symmetric(a, n_bits)
    bq, sb = quantize_symmetric(b, n_bits)
    dt = _cim_int_dtype(n_bits)
    return int_contract(aq.to(dt), bq.to(dt)).float() * (sa * sb)


def _mlp_quantized(p: Params, x: torch.Tensor, gating: str,
                   n_bits: int) -> torch.Tensor:
    """The quantized MLP as one plain function: the unlowered twin
    `mlp_cim` must match bit for bit."""
    h = _quantized_linear(x, p["w_in"], n_bits)
    if gating == "swiglu":
        h = F.silu(_quantized_linear(x, p["w_gate"], n_bits)) * h
    elif gating == "geglu":
        h = _gelu(_quantized_linear(x, p["w_gate"], n_bits)) * h
    else:
        h = _gelu(h)
    return _quantized_linear(h, p["w_out"], n_bits).to(x.dtype)


#: bounded LRU caches of lowered callables, keyed by everything that shapes
#: the capture (each LoweredFunction also bounds its per-signature
#: captures: no layer of this path grows without limit)
_LOWERED_CACHE_CAPACITY = 32
_LOWERED_LINEAR: "OrderedDict" = OrderedDict()
_LOWERED_MLP: "OrderedDict" = OrderedDict()


def _lru_get(cache, key, make):
    lf = cache.get(key)
    if lf is None:
        lf = cache[key] = make()
        while len(cache) > _LOWERED_CACHE_CAPACITY:
            cache.popitem(last=False)
    else:
        cache.move_to_end(key)
    return lf


def _resident_set(resident: bool, resident_spec):
    """The explicit ResidentSet a resident lowering pins into: the registry
    set of `resident_spec` (resolved per call, so clear_resident() takes
    effect), or None for the registry set of the lowering's own spec. A
    failover's spec override wins over `resident_spec`: the pins then move
    to the degraded geometry's set, as the reference's do."""
    if resident and resident_spec is not None \
            and array_mod.spec_override() is None:
        return array_mod.resident_set(resident_spec)
    return None


def _lowered_linear(n_bits: int, backend, spec, resident: bool = False,
                    resident_set=None):
    from repro_torch.cim.lower import lower

    return _lru_get(
        _LOWERED_LINEAR, (n_bits, backend, spec, resident, resident_set),
        lambda: lower(lambda x, w: _quantized_linear(x, w, n_bits),
                      backend=backend, spec=spec,
                      resident_argnums=(1,) if resident else (),
                      resident_set=resident_set))


def _lowered_mlp(gating: str, n_bits: int, backend, spec,
                 resident: bool = False, resident_set=None):
    from repro_torch.cim.lower import lower

    return _lru_get(
        _LOWERED_MLP, (gating, n_bits, backend, spec, resident, resident_set),
        lambda: lower(lambda p, x: _mlp_quantized(p, x, gating, n_bits),
                      backend=backend, spec=spec,
                      resident_argnums=(0,) if resident else (),
                      resident_set=resident_set))


def cim_linear(x: torch.Tensor, w: torch.Tensor, n_bits: int = 8,
               backend: Optional[str] = None,
               spec: Optional[array_mod.ArraySpec] = None,
               resident: bool = False,
               resident_spec: Optional[array_mod.ArraySpec] = None
               ) -> torch.Tensor:
    """x @ w through intN quantization as a `lower()` application: x
    [..., D], w [D, F] -> f32 [..., F], bit-exact with `_quantized_linear`;
    its one region is one dispatch on the banked `spec` (see the module
    note on `spec=None`). With `resident` the int8 weight planes are pinned
    at first call and reused while `w` is the same tensor."""
    if spec is None:
        spec = array_mod.spec_override()
    return _lowered_linear(n_bits, backend, spec, resident,
                           _resident_set(resident, resident_spec))(x, w)


def mlp_cim(p: Params, x: torch.Tensor, gating: str, n_bits: int = 8,
            backend: Optional[str] = None,
            spec: Optional[array_mod.ArraySpec] = None,
            resident: bool = False,
            resident_spec: Optional[array_mod.ArraySpec] = None
            ) -> torch.Tensor:
    """The quantized MLP through the lowering compiler: every integer
    contraction in the CiM array on the banked `spec` (`spec=None`:
    `array.spec_override()`, so a degraded spec installed with
    `set_current_spec` re-routes here too), one region each, and every
    float op (scales, gating) on the host. `resident=True` pins the int8
    weight planes in the registry ResidentSet of `resident_spec`, else of
    `spec`: pass the SAME weight tensors each call to stay warm."""
    if spec is None:
        spec = array_mod.spec_override()
    return _lowered_mlp(gating, n_bits, backend, spec, resident,
                        _resident_set(resident, resident_spec))(p, x)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embed_init(gen, vocab: int, d_model: int, dtype, device) -> Params:
    return {"table": _dense_init(gen, (vocab, d_model), d_model, dtype, device)}


def embed(p: Params, tokens: torch.Tensor, mesh=None,
          v0: int = 0) -> torch.Tensor:
    """Rows of the table for `tokens`. With `mesh`, p["table"] is this
    rank's vocab block (rows v0..): tokens outside it give zero rows and
    one all-reduce over "model" sums the ranks' rows (each token's row
    comes from the one rank that holds it, so the sum is exact)."""
    if mesh is None:
        return p["table"][tokens]
    n = p["table"].shape[0]
    local = tokens.long() - v0
    mine = (local >= 0) & (local < n)
    rows = p["table"][local.clamp(0, n - 1)]
    return rules.tp_exit(torch.where(mine[..., None], rows,
                                     torch.zeros((), dtype=rows.dtype,
                                                 device=rows.device)), mesh)


def lm_head_init(gen, d_model: int, vocab: int, dtype, device) -> Params:
    return {"w": _dense_init(gen, (d_model, vocab), d_model, dtype, device)}


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def chunked_lm_loss(x: torch.Tensor, w_head: torch.Tensor,
                    targets: torch.Tensor, real_vocab: int,
                    chunk: int = 512, mesh=None, v0: int = 0
                    ) -> torch.Tensor:
    """Mean CE over x [B, S, D] and targets [B, S] without materializing
    the [B, S, V] logits: sequence chunks of `chunk` tokens (the largest
    divisor of S not above it), each run under `torch.utils.checkpoint` (the
    reference's `jax.checkpoint`), so its logits are recomputed in the
    backward and peak memory is one chunk's logits. Padded vocab columns
    are masked to -1e30. With `mesh`, w_head is this rank's column block
    (vocab columns v0..) and the CE is vocab-parallel
    (`cross_entropy_split`): no rank holds a chunk's whole logits."""
    b, s, _ = x.shape
    v = w_head.shape[-1]
    c = chunk
    while s % c:
        c -= 1
    cols = torch.arange(v0, v0 + v, device=x.device)
    pad_mask = (cols >= real_vocab) * (-1e30)
    if mesh is not None:
        x = rules.tp_enter(x, mesh)

    def body(xc, tc):
        logits = torch.matmul(xc.float(), w_head.float()) + pad_mask
        if mesh is not None:
            return torch.sum(cross_entropy_split(logits, tc, cols, mesh))
        return torch.sum(cross_entropy(logits, tc))

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(s // c):
        total = total + checkpoint(body, x[:, i * c:(i + 1) * c],
                                   targets[:, i * c:(i + 1) * c],
                                   use_reentrant=False,
                                   preserve_rng_state=False)
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


class _SplitMax(torch.autograd.Function):
    """The max over the vocab of logits split by column over "model" (one
    all-reduce); its gradient goes to the global argmax, split evenly over
    ties on every rank, as `torch.amax`'s over the whole row."""

    @staticmethod
    def forward(ctx, logits, mesh):
        m = rules.model_max(torch.amax(logits, dim=-1), mesh)
        ctx.save_for_backward(logits, m)
        ctx.mesh = mesh
        return m

    @staticmethod
    def backward(ctx, g):
        logits, m = ctx.saved_tensors
        hit = logits == m[..., None]
        count = rules.model_sum(hit.sum(-1).to(g.dtype), ctx.mesh)
        return (g / count)[..., None] * hit, None


def cross_entropy_split(logits_f32: torch.Tensor, targets: torch.Tensor,
                        cols: torch.Tensor, mesh) -> torch.Tensor:
    """`cross_entropy` over logits split by column over "model" (this
    rank's columns `cols`): the row max, the sum of exponentials and the
    target logit each summed over the ranks (one all-reduce of the max,
    one of the two sums), the same function and gradient (+1 at the global
    argmax) as over the whole row."""
    m = _SplitMax.apply(logits_f32, mesh)
    shifted = logits_f32 - m.detach()[..., None]
    onehot = cols == targets[..., None]
    tgt = torch.sum(torch.where(onehot, logits_f32,
                                torch.zeros((), dtype=logits_f32.dtype,
                                            device=logits_f32.device)),
                    dim=-1)
    sums = rules.tp_exit(torch.stack([torch.sum(torch.exp(shifted), dim=-1),
                                      tgt]), mesh)
    return torch.log(sums[0]) + m - sums[1]
