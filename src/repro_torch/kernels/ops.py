"""Public entry points of the kernels — port of `repro.kernels.ops` for the
recurrences (RG-LRU, and sLSTM, which the reference reaches through
`repro.kernels.slstm.slstm_scan`). The reference picks Pallas or its jnp
oracle by a flag; here the tensor's device decides: CPU tensors take the
plain version, CUDA tensors the kernel (which raises on what it does not
take). There is no switch and no fallback.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import ref
from .rglru import rglru
from .slstm import slstm


def rglru_scan(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
               log_lambda: torch.Tensor, h0: Optional[torch.Tensor] = None,
               c: float = 8.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU over [B, T, D]: returns (y in x's dtype, h_T in float32)."""
    if x.device.type == "cpu":
        return ref.rglru_ref(x, r, i, log_lambda, h0=h0, c=c)
    return rglru(x, r, i, log_lambda, h0=h0, c=c)


def slstm_scan(wx: torch.Tensor, r_gates: torch.Tensor, b_gates: torch.Tensor,
               h0: torch.Tensor, c0: torch.Tensor, n0: torch.Tensor,
               m0: torch.Tensor):
    """sLSTM over wx [B, T, 4, D]: returns (y [B, T, D] in wx's dtype,
    (h, c, n, m) [B, D] in float32)."""
    if wx.device.type == "cpu":
        return ref.slstm_ref(wx, r_gates, b_gates, h0, c0, n0, m0)
    return slstm(wx, r_gates, b_gates, h0, c0, n0, m0)
