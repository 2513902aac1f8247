"""Public entry points of the kernels — port of `repro.kernels.ops` for the
recurrence. The reference picks Pallas or its jnp oracle by a flag; here
the tensor's device decides: CPU tensors take the plain version, CUDA
tensors the kernel (which raises on what it does not take). There is no
switch and no fallback.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import ref
from .rglru import rglru


def rglru_scan(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
               log_lambda: torch.Tensor, h0: Optional[torch.Tensor] = None,
               c: float = 8.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU over [B, T, D]: returns (y in x's dtype, h_T in float32)."""
    if x.device.type == "cpu":
        return ref.rglru_ref(x, r, i, log_lambda, h0=h0, c=c)
    return rglru(x, r, i, log_lambda, h0=h0, c=c)
