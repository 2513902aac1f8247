"""Expert-parallel MoE over a mesh.

Port of `repro.models.moe_ep`. Each "model"-axis rank OWNS n_experts / ep
experts ([shard * e_local, (shard + 1) * e_local), shard its coordinate),
tokens are split over the dp axis and replicated over "model", every rank
routes its tokens to its LOCAL experts only (`_local_moe`), and one
all-reduce over "model" combines the partial outputs: the reference's
`shard_map` body and its `psum`. The dp shards' outputs are then
all-gathered, so every rank returns the whole [B, T, D] routed output.

Capacity is counted per (dp shard, expert) over the shard's own choices, as
in the reference, so drops can differ from `moe.moe_apply` once an expert
overflows; with capacity to spare the summed partials equal its routed
output. On one rank the capacity per (shard, expert) is the global one
and the dispatch code is `moe.moe_apply`'s, so the outputs are equal.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from .moe import _top_k_gating, dispatch_combine, route

Params = dict


def _local_moe(router, w_in, w_gate, w_out, xf: torch.Tensor, *,
               cfg: ArchConfig, e_local: int, shard: int) -> torch.Tensor:
    """xf [N, D] (every token); w_* [E_local, ...] (this shard's experts).
    Returns the shard's partial routed output [N, D]."""
    m = cfg.moe
    n, _ = xf.shape
    e, k = m.n_experts, m.top_k
    e0 = shard * e_local

    logits = torch.matmul(xf.float(), router.float())
    weights, idx = _top_k_gating(logits, k, m.router_renorm)

    local = (idx >= e0) & (idx < e0 + e_local)
    lidx = torch.where(local, idx - e0, torch.zeros_like(idx))
    cap = max(int(m.capacity_factor * k * n / e), 1)
    onehot = F.one_hot(lidx, e_local).to(torch.int32) \
        * local[..., None].to(torch.int32)
    pos, fits = route(onehot, cap)
    return dispatch_combine(xf, weights, lidx, pos, local & fits, e_local,
                            cap, w_in, w_gate, w_out)


def moe_apply_ep(p: Params, cfg: ArchConfig, x: torch.Tensor, mesh,
                 axis: str = "model") -> torch.Tensor:
    """Routed-expert output under true expert parallelism (shared experts and
    the aux loss are computed by the caller / standard path). `x` [B, T, D]
    is the whole batch, equal on every rank; each rank takes its own rows
    and experts. The expert weights are DTensors placed by `param_specs`
    (experts on `axis`: each rank reads its own block, gathered over the
    other axes only) or plain tensors holding every expert (one rank's
    model; each rank slices its experts)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.mesh import sub_mesh
    from repro_torch.sharding import rules

    m = cfg.moe
    names = rules.axis_names(mesh)
    ep = mesh.size(names.index(axis))
    assert m.n_experts % ep == 0, (m.n_experts, ep)
    e_local = m.n_experts // ep
    shard = mesh.get_local_rank(axis)
    dp = "data" if "data" in names else names[0]
    n_dp = mesh.size(names.index(dp)) if dp != axis else 1
    dp_rank = mesh.get_local_rank(dp) if dp != axis else 0
    b, t, d = x.shape
    rows = b * t // n_dp
    xf = x.reshape(b * t, d)[dp_rank * rows:(dp_rank + 1) * rows]
    experts = slice(shard * e_local, (shard + 1) * e_local)

    def own(w):                   # this rank's experts of weight w
        if rules.tp_sharded(w, 0, axis):
            return rules.gather_param_tp(w, 0, axis)
        return rules.gather_param(w)[experts]
    w_in, w_gate, w_out = (own(p[k]) for k in ("w_in", "w_gate", "w_out"))
    assert w_in.shape[0] == e_local, (tuple(w_in.shape), e_local)
    y = _local_moe(rules.gather_param(p["router"]), w_in, w_gate, w_out, xf,
                   cfg=cfg, e_local=e_local, shard=shard)
    # ONE collective over the expert axis (the reference's psum), then the
    # dp shards' rows gathered
    sub = sub_mesh(mesh, axis)
    y = DTensor.from_local(y, sub, [Partial()], run_check=False) \
        .redistribute(sub, [Replicate()]).to_local()
    if dp != axis:
        y = DTensor.from_local(y, sub_mesh(mesh, dp), [Shard(0)],
                               run_check=False).full_tensor()
    return y.reshape(b, t, d)
