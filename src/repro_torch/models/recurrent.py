"""Griffin / RecurrentGemma recurrent block: conv1d + RG-LRU mixer.

Port of `repro.models.recurrent`. Block structure (Griffin):

    x -> [linear -> conv1d(w=4) -> RG-LRU] * gelu(linear gate) -> out proj

The recurrence goes through `repro_torch.kernels.ops.rglru_scan`: the CUDA
RG-LRU kernel for tensors on the card, its plain version on the CPU. The
five projections are plain matrix products (float32 accumulation, then the
activation dtype, as the reference's `preferred_element_type=float32`
einsums). Decode carries (conv tail, h) as an O(1) state.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.sharding import rules as shard_rules
from .layers import _dense_init, _gelu, _linear_f32

Params = Dict[str, torch.Tensor]

CONV_W = 4


def rglru_block_init(gen: torch.Generator, cfg: ArchConfig, dtype,
                     device) -> Params:
    d = cfg.d_model
    dr = d  # recurrent width = d_model
    # init so that a ~ U[0.9, 0.999]-ish decay band (Griffin appendix)
    ramp = torch.linspace(0.3, 0.8, dr, dtype=torch.float32, device=device)
    return {
        "w_x": _dense_init(gen, (d, dr), d, dtype, device),
        "w_gate": _dense_init(gen, (d, dr), d, dtype, device),
        "conv_w": _dense_init(gen, (CONV_W, dr), CONV_W, dtype, device),
        "conv_b": torch.zeros((dr,), dtype=dtype, device=device),
        "w_r": _dense_init(gen, (dr, dr), dr, dtype, device),
        "w_i": _dense_init(gen, (dr, dr), dr, dtype, device),
        "log_lambda": torch.log(torch.expm1(ramp)),
        "w_out": _dense_init(gen, (dr, d), dr, dtype, device),
    }


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            tail: Optional[torch.Tensor]):
    """Causal depthwise conv, width CONV_W. tail: [B, CONV_W-1, D] history.
    The four products are summed left to right in the activation dtype,
    then `b` is added (float32 where the bias stays float32), as the
    reference does."""
    bsz, t, d = x.shape
    if tail is None:
        tail = torch.zeros((bsz, CONV_W - 1, d), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)
    out = xp[:, 0:t] * w[0]
    for k in range(1, CONV_W):
        out = out + xp[:, k:k + t] * w[k]
    out = out + b
    return out.to(x.dtype), xp[:, -(CONV_W - 1):]


def rglru_block_apply(p: Params, cfg: ArchConfig, x: torch.Tensor,
                      state: Optional[Dict[str, torch.Tensor]] = None,
                      mesh=None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, T, D]. state: {"h": [B, D] f32, "conv": [B, 3, D]} or None
    (a zero state: prefill and train). Returns (out, new state).

    With `mesh` the block runs channel-parallel over "model", as the
    reference's specs place it: p holds this rank's channels (w_x, w_gate
    and conv_w by column, w_r, w_i and w_out by row, conv_b and log_lambda
    cut to them) and the state its channels. The conv and the scan are
    per channel, so they run on the rank's block (the scan on the kernel,
    at [B, T, D/m]); r and i are partial sums over the rank's rows of w_r
    and w_i, reduce-scattered to the rank's channels (one collective for
    both), and w_out's partial output is summed by one all-reduce."""
    if mesh is not None:
        x = shard_rules.tp_enter(x, mesh)
    xr = _linear_f32(x, p["w_x"]).to(x.dtype)
    gate = _linear_f32(x, p["w_gate"]).to(x.dtype)
    tail = state["conv"] if state is not None else None
    xc, new_tail = _conv1d(xr, p["conv_w"], p["conv_b"], tail)
    if mesh is None:
        r = _linear_f32(xc, p["w_r"]).to(x.dtype)
        i = _linear_f32(xc, p["w_i"]).to(x.dtype)
    else:
        ri = shard_rules.tp_scatter(torch.stack(
            [_linear_f32(xc, p["w_r"]), _linear_f32(xc, p["w_i"])]), mesh, -1)
        r, i = (t.to(x.dtype).contiguous() for t in ri)
    h0 = state["h"] if state is not None else None
    y, h_last = kops.rglru_scan(xc, r, i, p["log_lambda"], h0=h0)
    y = y * _gelu(gate.float()).to(x.dtype)
    out = _linear_f32(y, p["w_out"])
    if mesh is not None:
        out = shard_rules.tp_exit(out, mesh)
    return out.to(x.dtype), {"h": h_last, "conv": new_tail}


def rglru_make_state(cfg: ArchConfig, batch: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    return {"h": torch.zeros((batch, d), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, CONV_W - 1, d), dtype=dtype,
                                device=device)}
