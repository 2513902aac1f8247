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
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.sharding import rules as shard_rules
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


def _sdpa(q, k, v, mask, scale, scores_reduce=None) -> torch.Tensor:
    """[B,Tq,H,D] x [B,Tk,Hkv,D] grouped attention with explicit mask,
    f32 accumulation, output in q's dtype. `scores_reduce` sums the scores
    of a tensor-parallel rank's block of head_dim over the ranks (`scale`
    is then the whole head's)."""
    b, tq, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    qg = (q * torch.tensor(scale, dtype=q.dtype)).reshape(b, tq, hkv, group, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    if scores_reduce is not None:
        logits = scores_reduce(logits)
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


def _window_mask(tq: int, tk: int, window: int, device) -> torch.Tensor:
    mask = _causal_mask(tq, tk, device)
    if window:
        qpos = torch.arange(tq, device=device)[:, None] + (tk - tq)
        kpos = torch.arange(tk, device=device)[None, :]
        mask = mask & (qpos - kpos < window)[None]
    return mask


def _attend(q, k, v, scale, window: int = 0, scores_reduce=None):
    """Causal attention: dense (exact) below the blockwise threshold, the
    blockwise custom-backward form from it; `window` > 0 also masks keys
    `window` or more positions behind the query (sliding-window local
    attention). With `scores_reduce` (q, k, v a tensor-parallel rank's
    block of head_dim: see `_sdpa`) it is the dense form, from the
    threshold over query blocks of 512 that each read only the keys they
    can see and rerun in the backward."""
    if scores_reduce is not None:
        return _attend_split(q, k, v, scale, window, scores_reduce)
    if q.shape[1] >= BLOCKWISE_MIN_LEN:
        return blockwise_attention(q, k, v, True, scale, window, 512)
    mask = _window_mask(q.shape[1], k.shape[1], window, q.device)
    return _sdpa(q, k, v, mask, scale)


def _attend_split(q, k, v, scale, window, scores_reduce, block: int = 512):
    t = q.shape[1]
    if t < BLOCKWISE_MIN_LEN:
        mask = _window_mask(t, t, window, q.device)
        return _sdpa(q, k, v, mask, scale, scores_reduce)

    def part(qb, kb, vb):     # the block's queries end where its keys do
        mask = _window_mask(qb.shape[1], kb.shape[1], window, q.device)
        return _sdpa(qb, kb, vb, mask, scale, scores_reduce)
    outs = []
    for q0 in range(0, t, block):
        q1 = min(q0 + block, t)
        k0 = max(0, q0 - window + 1) if window else 0
        args = (q[:, q0:q1], k[:, k0:q1], v[:, k0:q1])
        outs.append(checkpoint(part, *args, use_reentrant=False)
                    if torch.is_grad_enabled() else part(*args))
    return torch.cat(outs, dim=1)


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
    return y, _dense_cache(k, v, max_len)


def _dense_cache(k, v, max_len: int) -> Params:
    """A prompt's K/V [B, T, Hkv, hd] at the head of a `max_len` cache."""
    shape = (k.shape[0], max_len) + tuple(k.shape[2:])
    cache = {"k": torch.zeros(shape, dtype=k.dtype, device=k.device),
             "v": torch.zeros(shape, dtype=v.dtype, device=v.device)}
    cache["k"][:, :k.shape[1]] = k
    cache["v"][:, :v.shape[1]] = v
    return cache


def _dense_write(cache, k, v, positions):
    """The cache with one token's K/V at `positions` [B], and the valid
    mask [B, S] of the positions up to it."""
    bidx = torch.arange(k.shape[0], device=k.device)
    ck, cv = cache["k"].clone(), cache["v"].clone()
    pos = positions.long()
    ck[bidx, pos] = k[:, 0]
    cv[bidx, pos] = v[:, 0]
    t_max = ck.shape[1]
    valid = torch.arange(t_max, device=k.device)[None, :] <= positions[:, None]
    return ck, cv, valid


def _decode_cache(cfg, x, cache, positions, p):
    q, k, v = _gqa_qkv(p, cfg, x, positions[:, None])
    return (q,) + _dense_write(cache, k, v, positions)


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
    return y, _ring_cache(k, v, w)


def _ring_cache(k, v, w: int) -> Params:
    """A prompt's last `w` K/V [B, T, Hkv, hd] in the ring layout (slot =
    pos % w)."""
    t = k.shape[1]
    shape = (k.shape[0], w) + tuple(k.shape[2:])
    cache = {"k": torch.zeros(shape, dtype=k.dtype, device=k.device),
             "v": torch.zeros(shape, dtype=v.dtype, device=v.device)}
    if t >= w:
        slots = torch.arange(t - w, t, device=k.device) % w
        cache["k"][:, slots] = k[:, t - w:]
        cache["v"][:, slots] = v[:, t - w:]
    else:
        cache["k"][:, :t] = k
        cache["v"][:, :t] = v
    return cache


def _ring_write(cache, k, v, positions, w: int):
    """The ring with one token's K/V in slot positions % w, and the valid
    mask [B, w]: a slot is valid when the absolute position it holds is
    >= 0 and within the window of `positions`."""
    slot = (positions % w).long()
    bidx = torch.arange(k.shape[0], device=k.device)
    ck, cv = cache["k"].clone(), cache["v"].clone()
    ck[bidx, slot] = k[:, 0]
    cv[bidx, slot] = v[:, 0]
    slot_ids = torch.arange(w, device=k.device)[None, :]
    # absolute position held by slot s: positions - ((positions - s) mod w)
    abs_pos = positions[:, None] - (positions[:, None] - slot_ids) % w
    valid = (abs_pos >= 0) & (abs_pos >= positions[:, None] - (w - 1))
    return ck, cv, valid


def local_decode(p, cfg: ArchConfig, x, cache: Params,
                 positions) -> Tuple[torch.Tensor, Params]:
    """x: [B, 1, D]; positions: [B] = absolute index of the new token, which
    lands in slot positions % window."""
    q, k, v = _gqa_qkv(p, cfg, x, positions[:, None])
    ck, cv, valid = _ring_write(cache, k, v, positions, cfg.local_window)
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


def _mla_project(p, cfg: ArchConfig, x, positions, q=None):
    """(q_nope, q_rope [B,T,H,*], c_kv [B,T,R] normed, k_rope [B,T,rope]);
    `q`, when given, is x's query projection."""
    m = cfg.mla
    q = _proj(x, p["wq"]) if q is None else q
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


def _mla_full(p, cfg: ArchConfig, x, positions, reduce=None):
    """MLA over a whole sequence: the output and the latent K/V (`reduce`
    as in `_out_proj`)."""
    q_nope, q_rope, c_kv, k_rope = _mla_project(p, cfg, x, positions)
    if x.shape[1] >= BLOCKWISE_MIN_LEN:
        o = _mla_attend_blockwise(p, cfg, q_nope, q_rope, c_kv, k_rope)
    else:
        mask = _causal_mask(x.shape[1], x.shape[1], x.device)
        o = _mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope, mask)
    return _out_proj(o.to(x.dtype), p["wo"], x.dtype, reduce), c_kv, k_rope


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
    return y, _latent_cache(c_kv, k_rope, max_len)


def _latent_cache(c_kv, k_rope, max_len: int) -> Params:
    """A prompt's latent and rope K [B, T, *] at the head of a `max_len`
    cache."""
    cache = {}
    for name, t in (("c_kv", c_kv), ("k_rope", k_rope)):
        cache[name] = torch.zeros((t.shape[0], max_len, t.shape[-1]),
                                  dtype=t.dtype, device=t.device)
        cache[name][:, :t.shape[1]] = t
    return cache


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


# ---------------------------------------------------------------------------
# Tensor parallelism over "model": a rank's block of heads or of head_dim
# (the reference's specs: `sharding.rules._rule`), joined by the collectives
# of `sharding.rules` (tp_enter / tp_exit / tp_sum / tp_gather /
# tp_scatter). The caches' specs split the feature dim (head_dim, the MLA
# latent and rope widths) over "model", so a rank keeps that block of every
# cache; decode scores are partial over it and summed by one all-reduce.
# ---------------------------------------------------------------------------


def _qk_block(x, w, norm, cfg: ArchConfig, positions, mesh, rope=True):
    """x's projection on w's block of head_dim (this rank's), with the qk
    norm over the whole head (its sum of squares summed over the ranks)
    and RoPE at the block's offset."""
    t = _proj(x, w)
    hd = cfg.head_dim
    if norm is not None:
        tf = t.float()
        ss = shard_rules.tp_sum((tf * tf).sum(-1, keepdim=True), mesh)
        y = tf * torch.rsqrt(ss / hd + cfg.norm_eps)
        scale = norm["scale"][shard_rules.model_block(mesh, hd)]
        t = (y * scale.float()).to(t.dtype)
    if not rope:
        return t
    off = shard_rules.model_block(mesh, hd).start
    return apply_rope(t, positions, cfg.rope_theta, width=hd, offset=off)


def _qk_whole(x, w, norm, cfg: ArchConfig, positions):
    t = _proj(x, w)
    if norm is not None:
        t = rmsnorm(norm, t, cfg.norm_eps)
    return apply_rope(t, positions, cfg.rope_theta)


def _scores_sum(mesh):
    return lambda s: shard_rules.tp_sum(s, mesh)


def _core(q, k, v, cfg: ArchConfig, window: int, use_flash: bool):
    if use_flash:
        return kops.attention(q, k, v, causal=True)
    return _attend(q, k, v, 1.0 / cfg.head_dim ** 0.5, window=window)


def gqa_heads_tp(p, cfg: ArchConfig, x, positions, mesh, window: int = 0,
                 use_flash: bool = False, kv_whole: bool = False,
                 keep_kv: bool = False):
    """Train or prefill attention over this rank's block of query heads
    (p["wq"] [D, Hr, hd], p["wo"] [Hr, hd, D]) and the key/value heads
    they read: p["wk"]/p["wv"] this rank's block of kv heads, or with
    `kv_whole` every kv head (gathered whole: the kv groups straddle the
    ranks), of which the rank reads its own. Returns (y after one
    all-reduce, and with `keep_kv` this rank's head_dim block of every kv
    head's K and V for the caches, else None)."""
    x = shard_rules.tp_enter(x, mesh)
    hq = p["wq"].shape[1]
    group = cfg.n_heads // cfg.n_kv_heads
    k0 = shard_rules.model_rank(mesh) * hq // group
    k1 = max(k0 + 1, (shard_rules.model_rank(mesh) + 1) * hq // group)
    wk, wv = p["wk"], p["wv"]
    if kv_whole and not keep_kv:         # only the heads this rank reads
        wk, wv = wk[:, k0:k1], wv[:, k0:k1]
    q = _qk_whole(x, p["wq"], p.get("q_norm"), cfg, positions)
    k = _qk_whole(x, wk, p.get("k_norm"), cfg, positions)
    v = _proj(x, wv)
    kv = None
    if keep_kv:
        blk = shard_rules.model_block(mesh, cfg.head_dim)
        if kv_whole:
            kv = (k[..., blk], v[..., blk])
            k, v = k[:, :, k0:k1], v[:, :, k0:k1]
        else:
            kv = tuple(shard_rules.tp_gather(t, mesh, 2)[..., blk]
                       for t in (k, v))
    o = _core(q, k, v, cfg, window, use_flash)
    y = _out_proj(o, p["wo"], x.dtype,
                  lambda t: shard_rules.tp_exit(t, mesh))
    return y, kv


def gqa_head_dim_tp(p, cfg: ArchConfig, x, positions, mesh,
                    window: int = 0):
    """Train or prefill attention on this rank's block of head_dim of
    every head (wq, wk, wv [D, H, hd/m], wo [H, hd/m, D]): partial scores
    summed by one all-reduce, the softmax on the whole scores, P V and
    the row-parallel wo on the block, one all-reduce. Returns (y, (k, v)
    this rank's blocks, the caches' layout)."""
    x = shard_rules.tp_enter(x, mesh)
    q = _qk_block(x, p["wq"], p.get("q_norm"), cfg, positions, mesh)
    k = _qk_block(x, p["wk"], p.get("k_norm"), cfg, positions, mesh)
    v = _proj(x, p["wv"])
    o = _attend(q, k, v, 1.0 / cfg.head_dim ** 0.5, window=window,
                scores_reduce=_scores_sum(mesh))
    y = _out_proj(o, p["wo"], x.dtype,
                  lambda t: shard_rules.tp_exit(t, mesh))
    return y, (k, v)


def gqa_decode_tp(p, cfg: ArchConfig, x, cache: Params, positions, mesh,
                  window: int = 0):
    """One decode step on this rank's head_dim block of the cache (dense,
    or the ring with `window`). Queries and the new K/V come from the
    rank's blocks of heads (gathered over the ranks, then the head_dim
    block taken) or of head_dim, as the weights are split; the scores
    [B, H, 1, S] are summed by one all-reduce; the output's head_dim
    blocks are gathered back to heads where wo is split by head."""
    pos = positions[:, None]
    blk = shard_rules.model_block(mesh, cfg.head_dim)

    def proj(w, norm, rope=True):
        if w.shape[-1] == cfg.head_dim:      # a block of heads
            t = _qk_whole(x, w, norm, cfg, pos) if rope else _proj(x, w)
            return shard_rules.tp_gather(t, mesh, 2)[..., blk]
        return _qk_block(x, w, norm, cfg, pos, mesh, rope)
    q = proj(p["wq"], p.get("q_norm"))
    k = proj(p["wk"], p.get("k_norm"))
    v = proj(p["wv"], None, rope=False)
    if window:
        ck, cv, valid = _ring_write(cache, k, v, positions, window)
    else:
        ck, cv, valid = _dense_write(cache, k, v, positions)
    o = _sdpa(q, ck, cv, valid[:, None, :], 1.0 / cfg.head_dim ** 0.5,
              _scores_sum(mesh))
    if p["wo"].shape[1] == cfg.head_dim:     # wo by head: this rank's
        o = shard_rules.tp_gather(o, mesh, 3)[
            :, :, shard_rules.model_block(mesh, cfg.n_heads)]
    return _out_proj(o, p["wo"], x.dtype,
                     lambda t: shard_rules.tp_exit(t, mesh)), \
        {"k": ck, "v": cv}


def mla_heads_tp(p, cfg: ArchConfig, x, positions, mesh):
    """Train or prefill MLA on this rank's block of heads (wq, w_uk, w_uv
    by head, wo row-parallel; w_kv_a and the latent whole on every rank).
    Returns (y, (c_kv, k_rope) this rank's blocks of the latent and rope
    widths, the caches' layout)."""
    x = shard_rules.tp_enter(x, mesh)
    y, c_kv, k_rope = _mla_full(p, cfg, x, positions,
                                lambda t: shard_rules.tp_exit(t, mesh))
    m = cfg.mla
    return y, (c_kv[..., shard_rules.model_block(mesh, m.kv_lora_rank)],
               k_rope[..., shard_rules.model_block(mesh, m.qk_rope_dim)])


def _mla_latent_tp(p, cfg: ArchConfig, q_lat, q_rope, c_kv, k_rope, mask,
                   mesh):
    """Softmax(QK^T) of MLA's absorbed form from this rank's blocks of the
    latent (q_lat [B,T,H,R/m] against c_kv [B,S,R/m]) and of the rope
    width (q_rope [B,T,H,rope/m], k_rope [B,S,rope/m]): partial scores
    summed by one all-reduce. Returns the whole probabilities [B,H,T,S]."""
    s = torch.einsum("bthr,bsr->bhts", q_lat, c_kv.float()) + \
        torch.einsum("bthk,bsk->bhts", q_rope.float(), k_rope.float())
    logits = shard_rules.tp_sum(s, mesh) * _mla_scale(cfg)
    logits = torch.where(mask[:, None], logits,
                         torch.tensor(-1e30, dtype=logits.dtype,
                                      device=logits.device))
    return torch.softmax(logits, dim=-1)


def mla_head_dim_tp(p, cfg: ArchConfig, x, positions, mesh,
                    cache: Optional[Params] = None):
    """MLA where the specs split wq by its feature dim, w_uk and w_uv by
    the latent and wo by v_head_dim (heads not divisible by "model"): the
    queries gathered whole, the absorbed form on this rank's latent and
    rope blocks (`_mla_latent_tp`), the values' partial sums over the
    latent reduce-scattered to the rank's v_head_dim block for the
    row-parallel wo. Over a whole sequence (`cache` None) returns (y,
    (c_kv, k_rope) blocks); in decode (x [B, 1, D], positions [B]) it
    writes the new token into the cache blocks and returns (y, cache)."""
    m = cfg.mla
    rb = shard_rules.model_block(mesh, m.kv_lora_rank)
    eb = shard_rules.model_block(mesh, m.qk_rope_dim)
    x = shard_rules.tp_enter(x, mesh)
    pos = positions if cache is None else positions[:, None]
    q = shard_rules.tp_gather(_proj(x, p["wq"]), mesh, 3)
    q_nope, q_rope, c_kv, k_rope = _mla_project(p, cfg, x, pos, q=q)
    q_nope, q_rope = (shard_rules.tp_enter(t, mesh) for t in (q_nope, q_rope))
    if cache is None:
        t = x.shape[1]
        mask = _causal_mask(t, t, x.device)
        kv = (c_kv[..., rb], k_rope[..., eb])
        cc, cr = kv
    else:
        bidx = torch.arange(x.shape[0], device=x.device)
        at = positions.long()
        cc, cr = cache["c_kv"].clone(), cache["k_rope"].clone()
        cc[bidx, at] = c_kv[:, 0, rb]
        cr[bidx, at] = k_rope[:, 0, eb]
        mask = (torch.arange(cc.shape[1], device=x.device)[None, :]
                <= positions[:, None])[:, None, :]
        kv = {"c_kv": cc, "k_rope": cr}
    q_lat = torch.einsum("bthk,rhk->bthr", q_nope.float(), p["w_uk"].float())
    probs = _mla_latent_tp(p, cfg, q_lat, q_rope[..., eb], cc, cr, mask, mesh)
    o_lat = torch.einsum("bhts,bsr->bthr", probs, cc.float())
    o = torch.einsum("bthr,rhv->bthv", o_lat, p["w_uv"].float())
    o = shard_rules.tp_scatter(o, mesh, 3)
    return _out_proj(o.to(x.dtype), p["wo"], x.dtype,
                     lambda t: shard_rules.tp_exit(t, mesh)), kv


def mla_decode_heads_tp(p, cfg: ArchConfig, x, cache: Params, positions,
                        mesh):
    """MLA decode on this rank's block of heads and of the latent cache:
    the heads' absorbed queries gathered over the ranks and cut to the
    rank's latent and rope blocks, partial scores summed by one
    all-reduce, the latent output's blocks gathered back and cut to the
    rank's heads for w_uv and the row-parallel wo."""
    m = cfg.mla
    rb = shard_rules.model_block(mesh, m.kv_lora_rank)
    eb = shard_rules.model_block(mesh, m.qk_rope_dim)
    q_nope, q_rope, c_kv, k_rope = _mla_project(p, cfg, x, positions[:, None])
    bidx = torch.arange(x.shape[0], device=x.device)
    at = positions.long()
    cc, cr = cache["c_kv"].clone(), cache["k_rope"].clone()
    cc[bidx, at] = c_kv[:, 0, rb]
    cr[bidx, at] = k_rope[:, 0, eb]
    mask = (torch.arange(cc.shape[1], device=x.device)[None, :]
            <= positions[:, None])[:, None, :]
    q_lat = torch.einsum("bthk,rhk->bthr", q_nope.float(), p["w_uk"].float())
    q_lat = shard_rules.tp_gather(q_lat, mesh, 2)[..., rb]
    q_rope = shard_rules.tp_gather(q_rope, mesh, 2)[..., eb]
    probs = _mla_latent_tp(p, cfg, q_lat, q_rope, cc, cr, mask, mesh)
    o_lat = torch.einsum("bhts,bsr->bthr", probs, cc.float())
    o_lat = shard_rules.tp_gather(o_lat, mesh, 3)[
        :, :, shard_rules.model_block(mesh, cfg.n_heads)]
    o = torch.einsum("bthr,rhv->bthv", o_lat, p["w_uv"].float())
    return _out_proj(o.to(x.dtype), p["wo"], x.dtype,
                     lambda t: shard_rules.tp_exit(t, mesh)), \
        {"c_kv": cc, "k_rope": cr}
