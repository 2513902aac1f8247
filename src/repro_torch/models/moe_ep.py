"""Expert-parallel MoE: one shard's share of the routed experts.

Port of `repro.models.moe_ep._local_moe` on one card, with no collective:
shard `shard` owns experts [shard * e_local, (shard + 1) * e_local), routes
every token to those of its top-k choices that land there, and returns its
partial output. Summing the partials of all n_experts / e_local shards is
the reference's `psum` over the expert-parallel axis.

Capacity is counted per (shard, expert) over the shard's own choices, as
in the reference, so drops can differ from `moe.moe_apply` once an expert
overflows; with capacity to spare the summed partials equal its routed
output. `moe_apply_ep` and its `shard_map` wait for the mesh (ROADMAP A12).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from .moe import _top_k_gating, dispatch_combine, route


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
