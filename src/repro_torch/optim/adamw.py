"""AdamW with configurable state dtypes.

Port of `repro.optim.adamw` on the port's parameter tree (nested dicts and
lists of tensors, `Model.params()`): the same float32 update math and the
same state dtypes (`state_dtype="bfloat16"` halves optimizer memory). The
reference is pure-functional; here `update` writes the new parameters into
the `nn.Parameter`s and the new moments into the state's tensors in place,
under `torch.no_grad()`, so a full-width step holds one copy of each.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.tree import leaves, tree_map

Params = Any


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"


def init(params: Params, cfg: AdamWConfig) -> Dict[str, Any]:
    dt = torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32

    def zeros(p):      # a DTensor parameter's moments are placed alike
        return torch.zeros_like(p, dtype=dt, requires_grad=False,
                                memory_format=torch.contiguous_format)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=leaves(params)[0].device)}


def global_norm(tree: Params) -> torch.Tensor:
    """The norm over every leaf (a DTensor leaf's square sum all-reduced
    first, so the result is a plain tensor)."""
    return torch.sqrt(sum(_full(torch.sum(torch.square(g.float())))
                          for g in leaves(tree)))


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def update(grads: Params, state: Dict[str, Any], params: Params,
           cfg: AdamWConfig, lr=None) -> Tuple[Params, Dict[str, Any],
                                               Dict[str, torch.Tensor]]:
    """One step: clip, moments, bias correction, decoupled weight decay.
    `params` and the state's moments are updated in place and returned
    (with the state's count advanced) beside {"grad_norm"}. Each gradient
    is clipped as `clip_by_global_norm` clips it, one leaf at a time, so no
    clipped copy of the whole tree is held."""
    lr = cfg.lr if lr is None else lr
    gnorm = global_norm(grads)
    clip = _clip_scale(gnorm, cfg.grad_clip)
    count = state["count"] + 1
    cf = count.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=cf.device), cf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=cf.device), cf)
    for g, m, v, p in zip(leaves(grads), leaves(state["m"]),
                          leaves(state["v"]), leaves(params)):
        dev = p.device
        gf = (g.float() * clip.to(dev)).to(g.dtype).float()
        mf = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        vf = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
        step = (mf / b1c.to(dev)) / (torch.sqrt(vf / b2c.to(dev)) + cfg.eps)
        pf = p.float()
        lr_t = torch.as_tensor(lr, dtype=torch.float32, device=dev)
        p.copy_(pf - lr_t * (step + cfg.weight_decay * pf))
        m.copy_(mf)
        v.copy_(vf)
    state = {"m": state["m"], "v": state["v"], "count": count}
    return params, state, {"grad_norm": gnorm}


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """lr(step): linear warmup, then cosine decay to 0 (float32)."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(torch.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr
