"""xLSTM blocks: mLSTM (matrix memory, parallelizable) and sLSTM (scalar
memory with exponential gating and a stabilizer state).

Port of `repro.models.xlstm`. mLSTM block: up-projection (factor 2) ->
q, k, v and the i/f/o gates -> mLSTM cell -> output norm -> down-projection.
sLSTM block: sLSTM cell -> gated FFN (factor 4/3). Both carry O(1) state
per layer between decode steps, kept as named dicts of float32 tensors
with the batch first, so a batch-1 prefill state lands in a serve slot as
it is:
  mLSTM: {"C": [B, H, dh, dh], "n": [B, H, dh], "m": [B, H]}
  sLSTM: {"h", "c", "n", "m"}: [B, D] each

The mLSTM cell is plain PyTorch: the sequential form below 32 tokens (and
for decode), the chunkwise-parallel form from 32 tokens on. The sLSTM
recurrence goes through `repro_torch.kernels.ops.slstm_scan`: the CUDA
sLSTM kernel for tensors on the card, its plain version on the CPU.

Dtypes follow the reference: the `preferred_element_type=x.dtype`
contractions accumulate in float32 and round to the activation dtype;
where the reference contracts float32 with a bfloat16 weight (JAX promotes
to float32: `w_ifo`, `r_gates`, and the biases `b_if`, `b_gates` after the
model's compute cast), the weight is upcast and the product is float32.
Both cells train under autograd: the chunkwise mLSTM checkpoints each
chunk, as the reference's `jax.checkpoint` of its chunk body does; the
sequential scans are Python loops (the reference's `chunked_scan` only
bounds its backward pass's memory), and the sLSTM kernel's backward
reruns its plain version (`kernels.ops.slstm_scan`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from .layers import _dense_init, _gelu, _linear_f32, rmsnorm, rmsnorm_init

Params = Dict[str, torch.Tensor]
State = Dict[str, torch.Tensor]

PF_MLSTM = 2.0
PF_SLSTM = 4.0 / 3.0
#: prompts of at least this many tokens take the chunkwise mLSTM form
CHUNKWISE_MIN_T = 32


def pick_chunk(t: int, target: int = 256) -> int:
    """Largest divisor of t that is <= target (fallback: t)."""
    for c in range(min(target, t), 0, -1):
        if t % c == 0:
            return c
    return t


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(gen: torch.Generator, cfg: ArchConfig, dtype,
               device) -> Params:
    d = cfg.d_model
    di = int(PF_MLSTM * d)
    h = cfg.n_heads
    dh = di // h
    return {
        "w_up": _dense_init(gen, (d, di), d, dtype, device),
        "w_qkv": _dense_init(gen, (di, 3, h, dh), di, dtype, device),
        "w_ifo": _dense_init(gen, (di, 3, h), di, torch.float32, device),
        "b_if": torch.stack([torch.zeros((h,), device=device),  # f bias > 0
                             torch.full((h,), 3.0, device=device)]),
        "out_norm": rmsnorm_init(di, dtype, device),
        "w_down": _dense_init(gen, (di, d), di, dtype, device),
    }


def _inv_sqrt(dh: int, device) -> torch.Tensor:
    """1 / sqrt(dh) rounded as the reference's float32 `1.0 / jnp.sqrt(dh)`."""
    return 1.0 / torch.sqrt(torch.tensor(float(dh), device=device))


def _mlstm_cell(q, k, v, i_pre, f_pre, state: Optional[State]):
    """Sequential mLSTM with exponential gating and stabilizer m.

    q, k, v: [B, T, H, dh]; i_pre, f_pre: [B, T, H]; state: a dict or None
    (zeros, m = -inf). Returns (h_out [B, T, H, dh] float32, state')."""
    b, t, h, dh = q.shape
    scale = _inv_sqrt(dh, q.device)
    if state is None:
        state = _mlstm_state(b, h, dh, q.device)
    c, n, m = state["C"], state["n"], state["m"]
    qf, kf, vf = q.float(), k.float(), v.float()
    i_f, f_f = i_pre.float(), f_pre.float()
    hs = []
    for s in range(t):
        q_t, k_t, v_t, i_t, f_t = qf[:, s], kf[:, s], vf[:, s], i_f[:, s], \
            f_f[:, s]
        m_new = torch.maximum(f_t + m, i_t)          # log-space stabilizer
        i_eff = torch.exp(i_t - m_new)
        f_eff = torch.exp(f_t + m - m_new)
        k_s = k_t * scale
        c = f_eff[..., None, None] * c + i_eff[..., None, None] * (
            k_s[..., :, None] * v_t[..., None, :])
        n = f_eff[..., None] * n + i_eff[..., None] * k_s
        num = torch.einsum("bhkv,bhk->bhv", c, q_t)
        den = torch.abs(torch.einsum("bhk,bhk->bh", n, q_t))
        hs.append(num / torch.clamp(den, min=1.0)[..., None])
        m = m_new
    return torch.stack(hs, 1), {"C": c, "n": n, "m": m}


def _mlstm_chunkwise(q, k, v, i_pre, f_pre, state: State, chunk: int = 256):
    """Chunkwise-parallel mLSTM: the same function as `_mlstm_cell`, with
    the matrix state touched once per chunk of L = pick_chunk(T, chunk)
    steps (the reference's derivation: F = cumsum(f), D = i - F,
    g = max(m0, cummax(D)), weights e^{D_s - g_t} <= 1; the intra-chunk sum
    is an L x L masked product and the carry updates once per chunk)."""
    b, t, h, dh = q.shape
    scale = _inv_sqrt(dh, q.device)
    L = pick_chunk(t, chunk)
    nc = t // L

    def feat_chunks(a):        # [B, T, H, dh] -> [nc, B, H, L, dh]
        a = a.float().permute(0, 2, 1, 3).reshape(b, h, nc, L, dh)
        return a.movedim(2, 0)

    def gate_chunks(a):        # [B, T, H] -> [nc, B, H, L]
        a = a.float().permute(0, 2, 1).reshape(b, h, nc, L)
        return a.movedim(2, 0)

    qs, ks, vs = feat_chunks(q), feat_chunks(k) * scale, feat_chunks(v)
    is_, fs = gate_chunks(i_pre), gate_chunks(f_pre)
    causal = torch.tril(torch.ones((L, L), dtype=torch.float32,
                                   device=q.device))

    def chunk_body(c, n, m_in, qc, kc, vc, ic, fc):
        big_f = torch.cumsum(fc, dim=-1)                       # [B, H, L]
        big_d = ic - big_f
        big_m = torch.cummax(big_d, dim=2).values
        g = torch.maximum(m_in[..., None], big_m)              # [B, H, L]
        alpha = torch.exp(m_in[..., None] - g)                 # inter coeff.

        qk = torch.einsum("bhld,bhsd->bhls", qc, kc)           # [B, H, L, L]
        w = torch.exp(big_d[:, :, None, :] - g[..., None]) * causal
        qkw = qk * w
        intra = torch.einsum("bhls,bhsd->bhld", qkw, vc)
        num = alpha[..., None] * torch.einsum("bhkv,bhlk->bhlv", c, qc) \
            + intra
        den = alpha * torch.einsum("bhk,bhlk->bhl", n, qc) + qkw.sum(-1)
        h_out = num / torch.clamp(den.abs(), min=1.0)[..., None]

        g_l = g[..., -1]                                       # [B, H]
        decay = torch.exp(big_d - g_l[..., None])[..., None]   # [B, H, L, 1]
        beta = torch.exp(m_in - g_l)
        c = beta[..., None, None] * c + torch.einsum("bhsk,bhsv->bhkv",
                                                     kc * decay, vc)
        n = beta[..., None] * n + (kc * decay).sum(2)
        return h_out, c, n, big_f[..., -1] + g_l

    # under autograd each chunk is recomputed in the backward pass, as the
    # reference checkpoints its chunk body: only the carries stay saved
    train = torch.is_grad_enabled() and q.requires_grad
    c, n, m_in = state["C"], state["n"], state["m"]
    outs = []
    for ci in range(nc):
        xs = (qs[ci], ks[ci], vs[ci], is_[ci], fs[ci])
        h_out, c, n, m_in = (checkpoint(chunk_body, c, n, m_in, *xs,
                                        use_reentrant=False)
                             if train else chunk_body(c, n, m_in, *xs))
        outs.append(h_out)
    hs = torch.stack(outs, 0).movedim(0, 2).reshape(b, h, t, dh)
    return hs.permute(0, 2, 1, 3), {"C": c, "n": n, "m": m_in}


def mlstm_apply(p: Params, cfg: ArchConfig, x: torch.Tensor,
                state: Optional[State] = None) -> Tuple[torch.Tensor, State]:
    """x: [B, T, D]; state: a dict or None (the zero state). Returns
    (out [B, T, D] in x's dtype, state')."""
    b, t, _ = x.shape
    h = cfg.n_heads
    di = p["w_up"].shape[1]
    up = _linear_f32(x, p["w_up"]).to(x.dtype)
    qkv = _linear_f32(up, p["w_qkv"].reshape(di, -1)).to(x.dtype)
    qkv = qkv.reshape(b, t, 3, h, -1)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    ifo = _linear_f32(up, p["w_ifo"].reshape(di, -1)).reshape(b, t, 3, h)
    b_if = p["b_if"].float()
    i_pre = ifo[:, :, 0] + b_if[0]
    f_pre = F.logsigmoid(ifo[:, :, 1] + b_if[1])
    o_gate = torch.sigmoid(ifo[:, :, 2])
    if t >= CHUNKWISE_MIN_T:
        init = state if state is not None else _mlstm_state(
            b, h, q.shape[-1], x.device)
        hs, new_state = _mlstm_chunkwise(q, k, v, i_pre, f_pre, init)
    else:
        hs, new_state = _mlstm_cell(q, k, v, i_pre, f_pre, state)
    hs = hs * o_gate[..., None]
    hs = hs.reshape(b, t, -1).to(x.dtype)
    hs = rmsnorm(p["out_norm"], hs, cfg.norm_eps)
    return _linear_f32(hs, p["w_down"]).to(x.dtype), new_state


def _mlstm_state(batch: int, heads: int, dh: int, device) -> State:
    return {"C": torch.zeros((batch, heads, dh, dh), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((batch, heads, dh), dtype=torch.float32,
                             device=device),
            "m": torch.full((batch, heads), float("-inf"),
                            dtype=torch.float32, device=device)}


def mlstm_make_state(cfg: ArchConfig, batch: int, device) -> State:
    h = cfg.n_heads
    return _mlstm_state(batch, h, int(PF_MLSTM * cfg.d_model) // h,
                                 device)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_init(gen: torch.Generator, cfg: ArchConfig, dtype,
               device) -> Params:
    d = cfg.d_model
    df = int(PF_SLSTM * d)
    b_gates = torch.zeros((4, d), dtype=torch.float32, device=device)
    b_gates[2] = 3.0                                            # f bias > 0
    return {
        "w_gates": _dense_init(gen, (d, 4, d), d, torch.float32, device),
        "r_gates": _dense_init(gen, (d, 4, d), d, torch.float32, device),
        "b_gates": b_gates,
        "ffn_in": _dense_init(gen, (d, df), d, dtype, device),
        "ffn_gate": _dense_init(gen, (d, df), d, dtype, device),
        "ffn_out": _dense_init(gen, (df, d), df, dtype, device),
        "ffn_norm": rmsnorm_init(d, dtype, device),
    }


def slstm_apply(p: Params, cfg: ArchConfig, x: torch.Tensor,
                state: Optional[State] = None) -> Tuple[torch.Tensor, State]:
    """x: [B, T, D]; state: a dict or None (h = c = m = 0, n = 1). Returns
    (y + gated FFN(y) in x's dtype, state')."""
    b, t, d = x.shape
    wx = _linear_f32(x, p["w_gates"].to(x.dtype).reshape(d, 4 * d))
    wx = wx.to(x.dtype).float().reshape(b, t, 4, d)
    if state is None:
        state = _slstm_state(b, d, x.device)
    y, (h, c, n, m) = kops.slstm_scan(
        wx, p["r_gates"], p["b_gates"], state["h"], state["c"], state["n"],
        state["m"])
    y = y.to(x.dtype)
    yn = rmsnorm(p["ffn_norm"], y, cfg.norm_eps)
    hi = _linear_f32(yn, p["ffn_in"]).to(x.dtype)
    gi = _linear_f32(yn, p["ffn_gate"]).to(x.dtype)
    hi = (_gelu(gi.float()) * hi.float()).to(x.dtype)
    out = _linear_f32(hi, p["ffn_out"]).to(x.dtype)
    return y + out, {"h": h, "c": c, "n": n, "m": m}


def _slstm_state(batch: int, d: int, device) -> State:
    state = {k: torch.zeros((batch, d), dtype=torch.float32, device=device)
             for k in ("h", "c", "n", "m")}
    state["n"].fill_(1.0)
    return state


def slstm_make_state(cfg: ArchConfig, batch: int, device) -> State:
    return _slstm_state(batch, cfg.d_model, device)
