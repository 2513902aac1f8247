"""Plain PyTorch versions of the kernels — port of `repro.kernels.ref`.

Each mirrors one kernel's contract. The tests hold them to the reference's
oracles on the CPU, and `chip_smoke.py` holds the CUDA kernels to them on
the card. The CPU path of `ops` uses them too; nothing on the card's serve
path does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`, log(1 + e^x) as logaddexp(x, 0). Unlike
    `torch.nn.functional.softplus` it never switches to the identity
    (which that does above x = 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def rglru_ref(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
              log_lambda: torch.Tensor, h0: Optional[torch.Tensor] = None,
              c: float = 8.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (sigmoid(i_t) * x_t),
    a_t = exp(-c * softplus(log_lambda) * sigmoid(r_t)), in float32.

    x, r, i: [B, T, D]; log_lambda: [D]; h0: [B, D] or None (zeros).
    Returns (ys [B, T, D] in x's dtype, h_T [B, D] in float32). A plain
    loop over T: the reference's chunked scan only bounds its memory."""
    b, t, d = x.shape
    decay = softplus(log_lambda.float())
    a = torch.exp(-c * decay[None, None, :] * torch.sigmoid(r.float()))
    gated = torch.sigmoid(i.float()) * x.float()
    mult = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    h = (torch.zeros((b, d), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for s in range(t):
        h = a[:, s] * h + mult[:, s] * gated[:, s]
        ys.append(h)
    return torch.stack(ys, 1).to(x.dtype), h
