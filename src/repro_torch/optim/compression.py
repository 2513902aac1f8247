"""Int8 gradient compression with error feedback.

Port of `repro.optim.compression`: per leaf, g' = g + residual; q =
round(g' / s) clipped to int8 with s = max|g'| / 127; dq = q s; residual'
= g' - dq. The reference marks the hook where the int8 tensors would cross
a pod axis and sends nothing across it; `compress_tree` reproduces the
numerics for `--compress-grads` on plain (single-process) gradients.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import leaves, tree_map

Params = Any


def init_residuals(grads_like: Params) -> Params:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def compress(g: torch.Tensor, residual: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (q int8, scale float32 scalar, new_residual)."""
    gf = g.float() + residual
    scale = torch.amax(torch.abs(gf)) / 127.0
    safe = torch.clamp(scale, min=1e-20)
    q = torch.clamp(torch.round(gf / safe), -127, 127).to(torch.int8)
    dq = q.float() * safe
    return q, scale, gf - dq


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * torch.clamp(scale, min=1e-20)


def compress_tree(grads: Params, residuals: Params) -> Tuple[Params, Params]:
    """Quantize -> dequantize every leaf with error feedback. Returns
    (grads_after_qdq, new_residuals), both float32, shaped like `grads`."""
    res_in = iter(leaves(residuals))
    res_out = []

    def one(g):
        q, s, r = compress(g, next(res_in))
        res_out.append(r)
        return decompress(q, s)

    dq = tree_map(one, grads)
    it = iter(res_out)
    return dq, tree_map(lambda _: next(it), grads)
