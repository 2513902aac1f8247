"""Mixture-of-Experts layer: top-k token-choice routing with capacity and
optional shared (always-on) experts.

Port of `repro.models.moe` (`moe_init`, `_top_k_gating`, `moe_apply`) with
the reference's semantics to the bit where they are integers:

- dispatch is a scatter into per-expert [E, C, D] buffers by (expert,
  position within the expert), not a one-hot [N, E, C] einsum;
- capacity C = max(int(capacity_factor * k * N / E), 1);
- a choice's position within its expert is a cumsum over the [N*k, E]
  one-hot in token-major, choice-minor order, so which choices overflow
  (and drop) depends on that order;
- a dropped choice adds zeros at slot C - 1 and takes nothing back: its
  token falls through to the residual (GShard semantics);
- the Switch/GShard load-balancing aux loss over the first choice.

The router logits stay float32 (the model keeps `router` out of its
compute cast). The expert products are batched matmuls with float32
accumulation, as the reference's `preferred_element_type=float32` einsums
(`product_f32`: on the card, bf16 operands without a float32 copy);
the reference computes them outside any Pallas kernel. Its GSPMD layout
hints (`_hint`) have no counterpart: on a mesh the port's model gathers a
MoE layer's batch over the dp axes and runs this function on all rows
(`models/model.py`), and `moe_ep.moe_apply_ep` is the expert-parallel form.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.sharding import rules as shard_rules
from .layers import _dense_init

Params = Dict[str, Any]


def moe_init(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> Params:
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    p = {
        "router": _dense_init(gen, (d, m.n_experts), d, torch.float32, device),
        "w_in": _dense_init(gen, (m.n_experts, d, f), d, dtype, device),
        "w_gate": _dense_init(gen, (m.n_experts, d, f), d, dtype, device),
        "w_out": _dense_init(gen, (m.n_experts, f, d), f, dtype, device),
    }
    if m.n_shared:
        fs = f * m.n_shared
        p["shared_in"] = _dense_init(gen, (d, fs), d, dtype, device)
        p["shared_gate"] = _dense_init(gen, (d, fs), d, dtype, device)
        p["shared_out"] = _dense_init(gen, (fs, d), fs, dtype, device)
    return p


def top_k_desc(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis: descending, and of equal values
    the lower index first (a stable sort; `torch.topk` promises no order
    among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, e: int) -> torch.Tensor:
    """`F.one_hot(idx, e)` as a comparison: the same int64 one-hots without
    the host read of `idx`'s range that `one_hot` makes on the CPU (a CUDA
    graph capture refuses it)."""
    return (idx[..., None] == torch.arange(e, device=idx.device)) \
        .to(torch.int64)


def _top_k_gating(logits: torch.Tensor, k: int,
                  renorm: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [N, E] -> (weights [N, k], indices [N, k])."""
    probs = torch.softmax(logits, dim=-1)
    weights, idx = top_k_desc(probs, k)
    if renorm:
        weights = weights / torch.clamp(weights.sum(-1, keepdim=True),
                                        min=1e-9)
    return weights, idx


def route(onehot: torch.Tensor, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each choice's position within its expert and whether it fits:
    onehot [N, k, E] int -> (pos [N, k], keep [N, k] bool). Positions count
    the earlier choices of the same expert in token-major, choice-minor
    order."""
    n, k, e = onehot.shape
    flat = onehot.reshape(n * k, e)
    pos = torch.cumsum(flat, dim=0) - flat
    pos = (pos.reshape(n, k, e) * onehot).sum(-1)
    return pos, pos < cap


def product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (2-D, or batched 3-D) with float32 accumulation and a float32
    result, the reference's `preferred_element_type=float32` einsum. Two
    bfloat16 CUDA operands outside autograd go to the product's
    `out_dtype=float32` form: their products are exact in float32, so it is
    the same function as upcasting first, without a float32 copy of every
    expert's weights on each call. Elsewhere (float32, the CPU, a train
    step: that form has no derivative) the operands are upcast."""
    op = torch.bmm if a.dim() == 3 else torch.mm
    if (a.is_cuda and a.dtype == b.dtype == torch.bfloat16
            and not (torch.is_grad_enabled()
                     and (a.requires_grad or b.requires_grad))):
        return op(a, b, out_dtype=torch.float32)
    return op(a.float(), b.float())


def _swiglu_f32(x: torch.Tensor, w_in, w_gate, w_out) -> torch.Tensor:
    h = product_f32(x, w_in)
    g = product_f32(x, w_gate)
    h = (F.silu(g) * h).to(x.dtype)
    return product_f32(h, w_out)


def _swiglu(x: torch.Tensor, w_in, w_gate, w_out, mesh=None) -> torch.Tensor:
    """SwiGLU with float32 accumulation, the result in x's dtype. With
    `mesh` the weights are this rank's block of the hidden dim (w_in and
    w_gate by column, w_out by row): x enters a tensor-parallel region and
    the float32 partial output is summed over "model" before the cast."""
    if mesh is None:
        return _swiglu_f32(x, w_in, w_gate, w_out).to(x.dtype)
    y = _swiglu_f32(shard_rules.tp_enter(x, mesh), w_in, w_gate, w_out)
    return shard_rules.tp_exit(y, mesh).to(x.dtype)


def expert_ffn(xe: torch.Tensor, w_in, w_gate, w_out) -> torch.Tensor:
    """SwiGLU experts over [E, C, D] buffers, float32 accumulation, the
    result in xe's dtype."""
    return _swiglu(xe, w_in, w_gate, w_out)


def dispatch_combine(xf: torch.Tensor, weights: torch.Tensor,
                     idx: torch.Tensor, pos: torch.Tensor,
                     keep: torch.Tensor, n_experts: int, cap: int,
                     w_in, w_gate, w_out, mesh=None,
                     rows: Optional[slice] = None) -> torch.Tensor:
    """Scatter the kept choices into [E, C, D], run the experts, gather
    back and sum the k weighted choices of each token: [N, D], or with
    `rows` (a slice of xf's tokens) those tokens' outputs only. With
    `mesh`, every expert runs on this rank's block of its hidden dim: the
    choices are combined in float32 from the partial outputs and summed
    over "model" once, [N, D] (or the rows'), before the cast."""
    n, d = xf.shape
    k = idx.shape[1]
    fe = idx.reshape(n * k)
    fp = torch.clamp(pos.reshape(n * k), max=cap - 1)
    fk = keep.reshape(n * k).to(xf.dtype)
    src = torch.repeat_interleave(xf, k, dim=0) * fk[:, None]
    xe = torch.zeros((n_experts, cap, d), dtype=xf.dtype, device=xf.device)
    xe = xe.index_put((fe, fp), src, accumulate=True)
    if mesh is None:
        ye = expert_ffn(xe, w_in, w_gate, w_out)
    else:           # the weights scale each rank's partials: f, as xe
        ye = _swiglu_f32(shard_rules.tp_enter(xe, mesh), w_in, w_gate,
                         w_out)
        weights = shard_rules.tp_enter(weights, mesh)
    if rows is not None:
        choices = slice(rows.start * k, rows.stop * k)
        fe, fp, fk = fe[choices], fp[choices], fk[choices]
        weights, n = weights[rows], rows.stop - rows.start
    back = ye[fe, fp] * fk[:, None].to(ye.dtype)
    back = back.reshape(n, k, d) * weights[..., None].to(ye.dtype)
    if mesh is None:
        return back.sum(1)
    return shard_rules.tp_exit(back.sum(1), mesh).to(xf.dtype)


def moe_apply(p: Params, cfg: ArchConfig, x: torch.Tensor,
              routed_mesh=None, shared_mesh=None,
              rows: Optional[slice] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, D] -> (y, aux_loss). `routed_mesh` / `shared_mesh`: the
    routed / shared experts' weights are this rank's block of their hidden
    dim (the reference's "tp" expert sharding), run tensor-parallel over
    "model". `rows` (a slice of x's batch rows, a dp rank's): y holds
    those rows only, while routing, capacity, drops and the aux loss are
    the whole batch's, the same on every rank."""
    m = cfg.moe
    b, t, d = x.shape
    n = b * t
    e, k = m.n_experts, m.top_k
    cap = max(int(m.capacity_factor * k * n / e), 1)

    xf = x.reshape(n, d)
    logits = torch.matmul(xf.float(), p["router"].float())
    weights, idx = _top_k_gating(logits, k, m.router_renorm)
    onehot = _one_hot(idx, e).to(torch.int32)
    pos, keep = route(onehot, cap)
    tokens = None if rows is None else slice(rows.start * t, rows.stop * t)
    y = dispatch_combine(xf, weights, idx, pos, keep, e, cap,
                         p["w_in"], p["w_gate"], p["w_out"], routed_mesh,
                         tokens)

    if m.n_shared:
        y = y + _swiglu(xf if tokens is None else xf[tokens],
                        p["shared_in"], p["shared_gate"], p["shared_out"],
                        shared_mesh)

    me = torch.softmax(logits, dim=-1).mean(0)
    ce = _one_hot(idx[:, 0], e).float().mean(0)
    aux = e * torch.sum(me * ce)
    return y.reshape(-1, t, d), aux
