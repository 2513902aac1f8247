"""Dense GQA/MQA attention with RoPE, prefill/decode caches, and the int8
CiM decode attention.

Port of the dense path of `repro.models.attention`: `_sdpa`, the quantized
core and its CiM form, `_attend`, `gqa_apply` (the train path's attention),
`gqa_prefill`, `gqa_decode` and `gqa_decode_cim`, and the sliding-window
local attention with its ring buffer (`local_*`; float, as in the
reference, which lowers only `gqa_decode` to CiM), and DeepSeek-V2's
multi-head latent attention (`mla_*`: a latent c_kv / k_rope cache, the
absorbed form below `BLOCKWISE_MIN_LEN` and in decode, the explicit
blockwise form from it; float, as in the reference). Sequences of
`BLOCKWISE_MIN_LEN` tokens or more take the blockwise attention
(`blockwise_attention.py`), as the reference's `_attend` does.

`sdpa_cim` is a `lower()` application of the quantized core, as in the
reference: its two regions each hold one batched contraction (QK^T, AV),
two dispatches per call, banked on `spec` when one is given and unbanked
otherwise. KV streams into the array every decode step, as `gqa_decode_cim`
does in the reference: the functional cache update makes fresh tensors per
token.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from .blockwise_attention import blockwise_attention
from .layers import (
    _dense_init,
    _lru_get,
    apply_rope,
    quantized_batched_matmul,
    rmsnorm,
    rmsnorm_init,
)

#: the reference switches to blockwise attention at this length
BLOCKWISE_MIN_LEN = 1024

Params = Dict[str, Any]


def _sdpa(q, k, v, mask, scale) -> torch.Tensor:
    """[B,Tq,H,D] x [B,Tk,Hkv,D] grouped attention with explicit mask,
    f32 accumulation, output in q's dtype."""
    b, tq, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    qg = (q * torch.tensor(scale, dtype=q.dtype)).reshape(b, tq, hkv, group, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(-1e30, dtype=logits.dtype,
                                      device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, tq, hq, d).to(q.dtype)


def _sdpa_quantized_core(qs, k, v, mask, n_bits: int) -> torch.Tensor:
    """Quantized SDPA body captured by the lowering compiler. `qs` is the
    PRE-SCALED query [B,Tq,Hq,D] (the caller applies the scale, so the
    capture is keyed only on shapes and n_bits). Both contractions are
    canonical batched matmuls with batch dims (B, Hkv) and the grouped-query
    axis folded into M; mask, softmax and the layout transposes are host
    islands."""
    b, tq, hq, d = qs.shape
    tk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    qg = qs.reshape(b, tq, hkv, g, d).permute(0, 2, 3, 1, 4) \
        .reshape(b, hkv, g * tq, d)
    kt = k.float().permute(0, 2, 3, 1)                        # [B,Hkv,D,Tk]
    logits = quantized_batched_matmul(qg, kt, n_bits) \
        .reshape(b, hkv, g, tq, tk)
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(-1e30, dtype=logits.dtype,
                                      device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    vt = v.float().permute(0, 2, 1, 3)                        # [B,Hkv,Tk,Dv]
    out = quantized_batched_matmul(probs.reshape(b, hkv, g * tq, tk), vt,
                                   n_bits)
    return out.reshape(b, hkv, g, tq, dv).permute(0, 3, 1, 2, 4) \
        .reshape(b, tq, hq, dv)


def _sdpa_quantized(q, k, v, mask, scale, n_bits: int = 8) -> torch.Tensor:
    """Plain quantized twin of `_sdpa`: the function `sdpa_cim` must match
    bit for bit."""
    qs = q.float() * torch.tensor(scale, dtype=torch.float32)
    return _sdpa_quantized_core(qs, k, v, mask, n_bits).to(q.dtype)


#: bounded LRU of lowered SDPA callables (see layers._LOWERED_LINEAR)
_LOWERED_SDPA: "OrderedDict" = OrderedDict()


def _lowered_sdpa(n_bits: int, backend, spec, resident: bool = False):
    from repro_torch.cim import array
    from repro_torch.cim.lower import lower

    return _lru_get(
        _LOWERED_SDPA, (n_bits, backend, spec, resident),
        lambda: lower(
            lambda qs, k, v, mask: _sdpa_quantized_core(qs, k, v, mask,
                                                        n_bits),
            backend=backend, spec=spec,
            resident_argnums=(1, 2) if resident else (),
            resident_set=array.resident_set(spec) if resident else None))


def sdpa_cim(q, k, v, mask, scale, n_bits: int = 8,
             backend: Optional[str] = None, spec=None,
             resident: bool = False) -> torch.Tensor:
    """Grouped SDPA with QK^T and AV executed as planned CiM schedules on
    the banked `spec` (None: unbanked): two fused regions per call, so warm
    calls are exactly two dispatches whatever the batch, heads or length.
    `resident=True` pins the packed K^T/V planes by tensor identity: pass
    the SAME k/v tensors across calls to skip their entry packs (decode
    with a functionally-updated cache gets fresh tensors each step, so the
    serve path streams KV instead)."""
    qs = q.float() * torch.tensor(scale, dtype=torch.float32)
    lf = _lowered_sdpa(n_bits, backend, spec, resident)
    return lf(qs, k, v, mask).to(q.dtype)


def _causal_mask(tq: int, tk: int, device=None) -> torch.Tensor:
    # query block aligned to the END of the key span
    m = torch.ones((tq, tk), dtype=torch.bool, device=device)
    return torch.tril(m, diagonal=tk - tq)[None]


# ---------------------------------------------------------------------------
# GQA / MQA global attention
# ---------------------------------------------------------------------------


def gqa_init(gen, cfg: ArchConfig, dtype, device) -> Params:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": _dense_init(gen, (d, h, hd), d, dtype, device),
        "wk": _dense_init(gen, (d, hkv, hd), d, dtype, device),
        "wv": _dense_init(gen, (d, hkv, hd), d, dtype, device),
        "wo": _dense_init(gen, (h, hd, d), h * hd, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, device)
        p["k_norm"] = rmsnorm_init(hd, dtype, device)
    return p


def _proj(x, w) -> torch.Tensor:
    return torch.einsum("btd,dhk->bthk", x.float(), w.float()).to(x.dtype)


def _out_proj(o, wo, dtype, reduce=None) -> torch.Tensor:
    """The output projection; `reduce` (a tensor-parallel region's sum
    over ranks) is applied to the float32 result before the cast."""
    y = torch.einsum("bthk,hkd->btd", o.float(), wo.float())
    return (y if reduce is None else reduce(y)).to(dtype)


def _gqa_qkv(p, cfg: ArchConfig, x, positions):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(q, k, v, scale, window: int = 0):
    """Causal attention: dense (exact) below the blockwise threshold, the
    blockwise custom-backward form from it; `window` > 0 also masks keys
    `window` or more positions behind the query (sliding-window local
    attention)."""
    if q.shape[1] >= BLOCKWISE_MIN_LEN:
        return blockwise_attention(q, k, v, True, scale, window, 512)
    tq, tk = q.shape[1], k.shape[1]
    mask = _causal_mask(tq, tk, q.device)
    if window:
        qpos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        kpos = torch.arange(tk, device=q.device)[None, :]
        mask = mask & (qpos - kpos < window)[None]
    return _sdpa(q, k, v, mask, scale)


def gqa_apply(p, cfg: ArchConfig, x, positions,
              use_flash: bool = False, reduce=None) -> torch.Tensor:
    """Full-sequence GQA attention (the train path): with `use_flash` the
    attention core is `kernels.ops.attention` (the flash kernel on the
    card, `mha_ref` on the CPU), else `_attend`. The head counts are the
    weights' own (a tensor-parallel rank's block of heads), `reduce` as
    in `_out_proj`."""
    q, k, v = _gqa_qkv(p, cfg, x, positions)
    if use_flash:
        o = kops.attention(q, k, v, causal=True)
    else:
        o = _attend(q, k, v, 1.0 / cfg.head_dim ** 0.5)
    return _out_proj(o, p["wo"], x.dtype, reduce)


def gqa_make_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                   device) -> Params:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_prefill(p, cfg: ArchConfig, x, positions,
                max_len: int) -> Tuple[torch.Tensor, Params]:
    q, k, v = _gqa_qkv(p, cfg, x, positions)
    o = _attend(q, k, v, 1.0 / cfg.head_dim ** 0.5)
    y = _out_proj(o, p["wo"], x.dtype)
    t = k.shape[1]
    cache = gqa_make_cache(cfg, x.shape[0], max_len, x.dtype, x.device)
    cache["k"][:, :t] = k
    cache["v"][:, :t] = v
    return y, cache


def _decode_cache(cfg, x, cache, positions, p):
    q, k, v = _gqa_qkv(p, cfg, x, positions[:, None])
    bidx = torch.arange(x.shape[0], device=x.device)
    ck, cv = cache["k"].clone(), cache["v"].clone()
    pos = positions.long()
    ck[bidx, pos] = k[:, 0]
    cv[bidx, pos] = v[:, 0]
    t_max = ck.shape[1]
    valid = torch.arange(t_max, device=x.device)[None, :] <= positions[:, None]
    return q, ck, cv, valid


def gqa_decode(p, cfg: ArchConfig, x, cache: Params,
               positions) -> Tuple[torch.Tensor, Params]:
    """x: [B, 1, D]; positions: [B] = index of the new token."""
    q, ck, cv, valid = _decode_cache(cfg, x, cache, positions, p)
    o = _sdpa(q, ck, cv, valid[:, None, :], 1.0 / cfg.head_dim ** 0.5)
    return _out_proj(o, p["wo"], x.dtype), {"k": ck, "v": cv}


def gqa_decode_cim(p, cfg: ArchConfig, x, cache: Params, positions,
                   backend: Optional[str] = None
                   ) -> Tuple[torch.Tensor, Params]:
    """`gqa_decode` with QK^T and AV as planned batched CiM schedules at
    `cfg.cim_attention_bits` (or their host twin with cfg.cim_host_twin);
    rotary, softmax and the cache update stay on the host."""
    q, ck, cv, valid = _decode_cache(cfg, x, cache, positions, p)
    scale = 1.0 / cfg.head_dim ** 0.5
    if cfg.cim_host_twin:
        o = _sdpa_quantized(q, ck, cv, valid[:, None, :], scale,
                            n_bits=cfg.cim_attention_bits)
    else:
        o = sdpa_cim(q, ck, cv, valid[:, None, :], scale,
                     n_bits=cfg.cim_attention_bits, backend=backend)
    return _out_proj(o, p["wo"], x.dtype), {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# Sliding-window local attention with a ring-buffer cache
# (the cache is O(window), not O(context))
# ---------------------------------------------------------------------------


def local_apply(p, cfg: ArchConfig, x, positions,
                reduce=None) -> torch.Tensor:
    q, k, v = _gqa_qkv(p, cfg, x, positions)
    o = _attend(q, k, v, 1.0 / cfg.head_dim ** 0.5, window=cfg.local_window)
    return _out_proj(o, p["wo"], x.dtype, reduce)


def local_make_cache(cfg: ArchConfig, batch: int, dtype, device) -> Params:
    shape = (batch, cfg.local_window, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def local_prefill(p, cfg: ArchConfig, x,
                  positions) -> Tuple[torch.Tensor, Params]:
    """Windowed attention over the prompt, and its last `window` K/V in the
    ring layout (slot = pos % window). The reference computes the
    projections twice (once in `local_apply`); they are the same values."""
    q, k, v = _gqa_qkv(p, cfg, x, positions)
    w = cfg.local_window
    o = _attend(q, k, v, 1.0 / cfg.head_dim ** 0.5, window=w)
    y = _out_proj(o, p["wo"], x.dtype)
    t = k.shape[1]
    cache = local_make_cache(cfg, x.shape[0], k.dtype, x.device)
    if t >= w:
        slots = torch.arange(t - w, t, device=x.device) % w
        cache["k"][:, slots] = k[:, t - w:]
        cache["v"][:, slots] = v[:, t - w:]
    else:
        cache["k"][:, :t] = k
        cache["v"][:, :t] = v
    return y, cache


def local_decode(p, cfg: ArchConfig, x, cache: Params,
                 positions) -> Tuple[torch.Tensor, Params]:
    """x: [B, 1, D]; positions: [B] = absolute index of the new token, which
    lands in slot positions % window. A slot is valid when the absolute
    position it holds is >= 0 and within the window of `positions`."""
    q, k, v = _gqa_qkv(p, cfg, x, positions[:, None])
    w = cfg.local_window
    slot = (positions % w).long()
    bidx = torch.arange(x.shape[0], device=x.device)
    ck, cv = cache["k"].clone(), cache["v"].clone()
    ck[bidx, slot] = k[:, 0]
    cv[bidx, slot] = v[:, 0]
    slot_ids = torch.arange(w, device=x.device)[None, :]
    # absolute position held by slot s: positions - ((positions - s) mod w)
    abs_pos = positions[:, None] - (positions[:, None] - slot_ids) % w
    valid = (abs_pos >= 0) & (abs_pos >= positions[:, None] - (w - 1))
    o = _sdpa(q, ck, cv, valid[:, None, :], 1.0 / cfg.head_dim ** 0.5)
    return _out_proj(o, p["wo"], x.dtype), {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# DeepSeek-V2 Multi-head Latent Attention (MLA): a latent KV cache
# ---------------------------------------------------------------------------


def mla_init(gen, cfg: ArchConfig, dtype, device) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qd = m.qk_nope_dim + m.qk_rope_dim
    r = m.kv_lora_rank
    return {
        "wq": _dense_init(gen, (d, h, qd), d, dtype, device),
        "w_kv_a": _dense_init(gen, (d, r + m.qk_rope_dim), d, dtype, device),
        "kv_a_norm": rmsnorm_init(r, dtype, device),
        "w_uk": _dense_init(gen, (r, h, m.qk_nope_dim), r, dtype, device),
        "w_uv": _dense_init(gen, (r, h, m.v_head_dim), r, dtype, device),
        "wo": _dense_init(gen, (h, m.v_head_dim, d), h * m.v_head_dim, dtype,
                          device),
    }


def _mla_project(p, cfg: ArchConfig, x, positions):
    """(q_nope, q_rope [B,T,H,*], c_kv [B,T,R] normed, k_rope [B,T,rope])."""
    m = cfg.mla
    q = _proj(x, p["wq"])
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv_a = torch.matmul(x.float(), p["w_kv_a"].float()).to(x.dtype)
    c_kv, k_rope = kv_a[..., :m.kv_lora_rank], kv_a[..., m.kv_lora_rank:]
    c_kv = rmsnorm(p["kv_a_norm"], c_kv, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def _mla_scale(cfg: ArchConfig) -> float:
    return 1.0 / (cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim) ** 0.5


def _mla_attend(p, cfg: ArchConfig, q_nope, q_rope, c_kv, k_rope, mask):
    """The absorbed form, float32: W_uk folded into q, scores against the
    latent, values combined in the latent and decompressed once per query
    (per-head K is never expanded for the context). mask broadcasts to
    [B, T, S]. Returns o [B, T, H, v_head_dim] in float32."""
    q_lat = torch.einsum("bthk,rhk->bthr", q_nope.float(), p["w_uk"].float())
    s_nope = torch.einsum("bthr,bsr->bhts", q_lat, c_kv.float())
    s_rope = torch.einsum("bthk,bsk->bhts", q_rope.float(), k_rope.float())
    logits = (s_nope + s_rope) * _mla_scale(cfg)
    logits = torch.where(mask[:, None], logits,
                         torch.tensor(-1e30, dtype=logits.dtype,
                                      device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    o_lat = torch.einsum("bhts,bsr->bthr", probs, c_kv.float())
    return torch.einsum("bthr,rhv->bthv", o_lat, p["w_uv"].float())


def _mla_attend_blockwise(p, cfg: ArchConfig, q_nope, q_rope, c_kv, k_rope):
    """The explicit form for long prefill and train: per-head K_nope and V
    decompressed from the latent once, then blockwise attention over
    (nope + rope)-wide heads (the absorbed form's score work grows with
    kv_lora_rank, which long sequences cannot afford)."""
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv.float(),
                          p["w_uk"].float()).to(c_kv.dtype)
    v = torch.einsum("bsr,rhv->bshv", c_kv.float(),
                     p["w_uv"].float()).to(c_kv.dtype)
    h = k_nope.shape[2]
    k_cat = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        k_rope.shape[:2] + (h, k_rope.shape[-1]))], dim=-1)
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    return blockwise_attention(q_cat, k_cat, v, True, _mla_scale(cfg), 0, 512)


def _mla_full(p, cfg: ArchConfig, x, positions):
    """MLA over a whole sequence: the output and the latent K/V."""
    q_nope, q_rope, c_kv, k_rope = _mla_project(p, cfg, x, positions)
    if x.shape[1] >= BLOCKWISE_MIN_LEN:
        o = _mla_attend_blockwise(p, cfg, q_nope, q_rope, c_kv, k_rope)
    else:
        mask = _causal_mask(x.shape[1], x.shape[1], x.device)
        o = _mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope, mask)
    return _out_proj(o.to(x.dtype), p["wo"], x.dtype), c_kv, k_rope


def mla_apply(p, cfg: ArchConfig, x, positions) -> torch.Tensor:
    return _mla_full(p, cfg, x, positions)[0]


def mla_make_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                   device) -> Params:
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_dim),
                                  dtype=dtype, device=device)}


def mla_prefill(p, cfg: ArchConfig, x, positions,
                max_len: int) -> Tuple[torch.Tensor, Params]:
    y, c_kv, k_rope = _mla_full(p, cfg, x, positions)
    t = c_kv.shape[1]
    cache = mla_make_cache(cfg, x.shape[0], max_len, x.dtype, x.device)
    cache["c_kv"][:, :t] = c_kv
    cache["k_rope"][:, :t] = k_rope
    return y, cache


def mla_decode(p, cfg: ArchConfig, x, cache: Params,
               positions) -> Tuple[torch.Tensor, Params]:
    """x: [B, 1, D]; positions: [B]. Float on every path: MLA decode never
    lowers to CiM, in the reference either."""
    q_nope, q_rope, c_kv, k_rope = _mla_project(p, cfg, x, positions[:, None])
    bidx = torch.arange(x.shape[0], device=x.device)
    pos = positions.long()
    cc, cr = cache["c_kv"].clone(), cache["k_rope"].clone()
    cc[bidx, pos] = c_kv[:, 0]
    cr[bidx, pos] = k_rope[:, 0]
    valid = torch.arange(cc.shape[1], device=x.device)[None, :] \
        <= positions[:, None]
    o = _mla_attend(p, cfg, q_nope, q_rope, cc, cr, valid[:, None, :])
    return _out_proj(o.to(x.dtype), p["wo"], x.dtype), \
        {"c_kv": cc, "k_rope": cr}
