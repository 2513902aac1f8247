"""Plain PyTorch versions of the kernels — port of `repro.kernels.ref`,
the ADRA bit-plane oracles included.

Each mirrors one kernel's contract. The tests hold them to the reference's
oracles on the CPU, and `chip_smoke.py` holds the CUDA kernels to them on
the card. The CPU path of `ops` uses them too; nothing on the card's serve
or train path does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


# ---------------------------------------------------------------------------
# adra_bitplane oracles
# ---------------------------------------------------------------------------


def adra_bitplane_ref(a_planes: torch.Tensor, b_planes: torch.Tensor,
                      select: int):
    """Oracle for `adra_bitplane_op`: the plane-wise ripple (add for
    select 0, sub for select 1) over int32 planes holding uint32 patterns.
    Returns (sum planes [n_bits+1, W], carry [1, W], sign [1, W],
    zero [1, W])."""
    n_bits = a_planes.shape[0]
    b_eff = ~b_planes if select == 1 else b_planes
    carry = torch.full_like(a_planes[0], -1 if select == 1 else 0)
    sums = []
    nz = torch.zeros_like(a_planes[0])
    for i in range(n_bits):
        a, b = a_planes[i], b_eff[i]
        half = a ^ b
        s = half ^ carry
        carry = (a & b) | (carry & half)
        sums.append(s)
        nz = nz | s
    a_msb, b_msb = a_planes[n_bits - 1], b_eff[n_bits - 1]
    half = a_msb ^ b_msb
    s_ext = half ^ carry
    carry_out = (a_msb & b_msb) | (carry & half)
    nz = nz | s_ext
    sums.append(s_ext)
    return (torch.stack(sums), carry_out[None, :], s_ext[None, :],
            (~nz)[None, :])


def adra_int_ref(a: torch.Tensor, b: torch.Tensor, select: int,
                 n_bits: int):
    """Integer-semantics oracle: what the bit-plane machinery must equal
    (a - b for select 1, else a + b, with a < b and a == b as int32)."""
    a = torch.as_tensor(a).to(torch.int32)
    b = torch.as_tensor(b).to(torch.int32)
    res = a - b if select == 1 else a + b
    return res, (a < b).to(torch.int32), (a == b).to(torch.int32)


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


def slstm_ref(wx: torch.Tensor, r_gates: torch.Tensor, b_gates: torch.Tensor,
              h0: torch.Tensor, c0: torch.Tensor, n0: torch.Tensor,
              m0: torch.Tensor):
    """The sLSTM recurrence, in float32:

        pre = wx_t + h R + b;  z = tanh(pre_0); i = pre_1
        f = log_sigmoid(pre_2); o = sigmoid(pre_3)
        m' = max(f + m, i);  c = e^{f+m-m'} c + e^{i-m'} z
        n = e^{f+m-m'} n + e^{i-m'};  h = o c / max(n, 1e-6)

    wx: [B, T, 4, D] gate pre-activations (gates z, i, f, o); r_gates:
    [D, 4, D]; b_gates: [4, D] (either may be bfloat16: upcast); states
    [B, D]. Returns (y [B, T, D] in wx's dtype, (h, c, n, m) in float32).
    A plain loop over T, as `rglru_ref`. A float64 wx computes (and returns
    the state) in float64: the card's accuracy check of wide D uses it as
    the exact value."""
    b, t, _, d = wx.shape
    dt = torch.float64 if wx.dtype == torch.float64 else torch.float32
    r = r_gates.to(dt).reshape(d, 4 * d)
    bg = b_gates.to(dt)
    wxf = wx.to(dt)
    h, c, n, m = (s.to(dt) for s in (h0, c0, n0, m0))
    ys = []
    for s in range(t):
        pre = wxf[:, s] + torch.matmul(h, r).reshape(b, 4, d) + bg
        z = torch.tanh(pre[:, 0])
        i_t = pre[:, 1]
        f_t = torch.nn.functional.logsigmoid(pre[:, 2])
        o = torch.sigmoid(pre[:, 3])
        m_new = torch.maximum(f_t + m, i_t)
        i_eff = torch.exp(i_t - m_new)
        f_eff = torch.exp(f_t + m - m_new)
        c = f_eff * c + i_eff * z
        n = f_eff * n + i_eff
        h = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        ys.append(h)
    return torch.stack(ys, 1).to(wx.dtype), (h, c, n, m)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True, scale: Optional[float] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped-query attention in float32 accumulation: q [B, Tq, Hq, D],
    k and v [B, Tk, Hkv, D], kv heads repeated to q heads (q head h reads
    kv head h // (Hq / Hkv)), the causal mask `tril(k=Tk-Tq)` (queries
    aligned to the end of the key span) filled with -1e30.

    Returns (o [B, Tq, Hq, D] in q's dtype, lse [B, Hq, Tq] in float32):
    lse is the log-sum-exp of the scaled, masked logits, which the backward
    needs. A float64 q computes (and returns lse) in float64: the card's
    accuracy check of wide shapes uses it as the exact value."""
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / d ** 0.5 if scale is None else scale
    dt = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf = q.to(dt) * scale
    kf = k.to(dt).repeat_interleave(group, dim=2)
    vf = v.to(dt).repeat_interleave(group, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if causal:
        mask = torch.tril(torch.ones((tq, tk), dtype=torch.bool,
                                     device=q.device), diagonal=tk - tq)
        logits = torch.where(mask, logits, torch.full((), -1e30, dtype=dt,
                                                      device=q.device))
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return out.to(q.dtype), lse
