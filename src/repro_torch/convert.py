"""Carry the reference's parameters into the port.

`params_from_jax(np_params, cfg)` takes a `repro` model's parameter tree
with every leaf already converted to a numpy array (the caller does
`jax.tree.map(np.asarray, params)`), unstacks the scanned `groups` into
per-layer dicts in stack order (the `first_dense` prefix, the groups, the
remainder), and returns the port's parameter tree of
torch tensors on `device` (`cuda` unless the caller passes
`device="cpu"`), so both packages compute the same function on the same
weights. Every leaf goes over as it is, nested dicts included: the MoE
layer's `router`, its expert stacks `w_in`/`w_gate`/`w_out` ([G, E, ...]
in the reference's groups, [E, ...] per layer here) and `shared_*`, and
MLA's `wq`, `w_kv_a`, `kv_a_norm`, `w_uk`, `w_uv` and `wo`. This module
never imports jax.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig


def _to_torch(tree, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def _index(tree, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def params_from_jax(np_params: Dict[str, Any], cfg: ArchConfig,
                    device=None) -> Dict[str, Any]:
    """Reference param tree (numpy leaves) -> the port's param tree."""
    device = resolve_device(device)
    pattern = cfg.block_pattern
    groups = np_params.get("groups", ())
    n_groups = 0
    if groups:
        first_leaf = groups[0]
        while isinstance(first_leaf, dict):
            first_leaf = next(iter(first_leaf.values()))
        n_groups = int(np.shape(first_leaf)[0])
    layers: List[Dict[str, Any]] = list(np_params.get("first_dense", []))
    for g in range(n_groups):
        for pos in range(len(pattern)):
            layers.append(_index(groups[pos], g))
    layers.extend(np_params.get("rem", []))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: unstacked {len(layers)} layers, "
                         f"config has {cfg.n_layers}")
    out: Dict[str, Any] = {
        "layers": [_to_torch(p, device) for p in layers],
        "final_norm": _to_torch(np_params["final_norm"], device),
    }
    for name in ("embed", "lm_head"):
        if name in np_params:
            out[name] = _to_torch(np_params[name], device)
    return out
