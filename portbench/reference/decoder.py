"""The plain reference of the serve cells: a decoder in float32 PyTorch,
written from the configuration file's keys and the published equations,
that imports nothing of the program.

It replays what the serve engine did, event by event: a prefill of one
prompt into a slot, then decode steps over every slot at once, each with
the tokens and positions the engine fed it. So the quantities that couple
the rows of a batch are the same as the program's: the per-tensor scales
of the int8 CiM contractions and the MoE capacity (each expert keeps at
most max(int(capacity_factor * top_k * N / experts), 1) choices of a call's
N tokens, in token-major, choice-minor order; the rest are dropped and
counted in `dropped`). Where nothing couples the rows, a request's prompt
and served tokens are one prefill event of their own, read at every
position. Its caches are its own, in float32.

It replays layer by layer: each layer's weights are made float32 once;
the projections of every event's rows run together, then the events in
their order write their keys and values into the cache and attend over
it (each reads what the earlier ones wrote), and the MLP or MoE of every
event runs together, grouped by expert, each event keeping its own scales
and capacity. The result is what a step-by-step replay computes.

Equations (the port's, which the configuration file states): RMSNorm with
a scale; interleaved (adjacent-pair) rotary embeddings with frequencies
theta^(-2i/d); GQA with the score scale 1/sqrt(head_dim); DeepSeek-V2's
MLA in its explicit form (per-head keys and values decompressed from the
normed latent, rotary keys shared by the heads, score scale
1/sqrt(nope + rope)); SwiGLU MLPs silu(x W_gate) * (x W_in) W_out; top-k
softmax routing with the chosen weights renormalised when
`norm_topk_prob`, plus the shared experts; an untied head over the
vocabulary (padding columns dropped).

`precision` picks how it computes:
- "float32": every product in float32 (TF32 off);
- "fp8": the control of the float cells: every weight product's operands
  rounded to float8 e4m3, weights with a scale per matrix (amax / 448),
  activations with a scale per row (per token);
- "cimN": the dense MLPs' three products (prefill and decode) and decode
  attention's two products quantized as the program's CiM path states:
  symmetric per-tensor N-bit integers (a tensor: one call's operand),
  round half to even, scale max|x| / (2^(N-1) - 1), contracted exactly
  (float64), rescaled in float32. "cim8" is the CiM cell's reference,
  "cim4" its control.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def fp8_round(t: torch.Tensor, dims=None) -> torch.Tensor:
    """t rounded to float8 e4m3 under a scale over `dims` (None: the whole
    tensor)."""
    a = t.abs().amax() if dims is None else t.abs().amax(dim=dims, keepdim=True)
    s = torch.clamp(a, min=1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def quantize(x: torch.Tensor, bits: int):
    """Symmetric per-tensor quantization: (integer values as float64,
    float32 scale)."""
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.clamp(x.float().abs().max(), min=1e-8) / qmax
    q = torch.clamp(torch.round(x.float() / scale), -qmax, qmax)
    return q.double(), scale


def qmatmul(a: torch.Tensor, b: torch.Tensor, bits: int) -> torch.Tensor:
    """a @ b over per-tensor `bits`-bit quantized operands, the integer
    contraction exact, rescaled in float32."""
    qa, sa = quantize(a, bits)
    qb, sb = quantize(b, bits)
    return torch.matmul(qa, qb).float() * (sa * sb)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    var = (x * x).mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Interleaved rotary embedding: x [..., T, H, D], positions [..., T]."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = positions.float()[..., None] * inv                 # [..., T, D/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape)


class Decoder:
    """The reference over one weight tree (the benchmark's, in the layout
    the program loads: `embed/table`, `layers/i/...`, `final_norm/scale`,
    `lm_head/w`), for `slots` rows of caches of `max_len` positions."""

    def __init__(self, cfg: Dict[str, Any], weights: Dict[str, Any],
                 slots: int, max_len: int, precision: str = "float32"):
        self.cfg, self.w = cfg, weights
        self.slots, self.max_len = slots, max_len
        self.precision = precision
        self.bits = int(precision[3:]) if precision.startswith("cim") else 0
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])
        self.n_kv = int(cfg["num_key_value_heads"])
        self.mla = "kv_lora_rank" in cfg
        self.vocab = int(cfg["vocab_size"])
        self.device = weights["final_norm"]["scale"].device
        self.first_dense = int(cfg.get("first_k_dense_replace", 0))
        self.has_moe = "n_routed_experts" in cfg
        self.dropped = 0           # MoE choices over capacity, dropped

    # -- products -------------------------------------------------------------

    def w32(self, w: torch.Tensor, k: int = 1) -> torch.Tensor:
        """Weight `w`, its first `k` dims contracted, as a float32 matrix
        in this reference's precision (fp8-rounded, one scale a matrix, for
        the control)."""
        w2 = w.reshape(math.prod(w.shape[:k]), -1).float()
        return fp8_round(w2) if self.precision == "fp8" else w2

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation entering a weight product (fp8-rounded per row for
        the control)."""
        x = x.float()
        return fp8_round(x, dims=-1) if self.precision == "fp8" else x

    def mm(self, x: torch.Tensor, w32: torch.Tensor,
           out_shape=()) -> torch.Tensor:
        """x [..., in] @ w32 [in, out], reshaped to [..., *out_shape]."""
        y = self.act(x) @ w32
        return y.reshape(x.shape[:-1] + (tuple(out_shape) or (w32.shape[1],)))

    # -- attention ----------------------------------------------------------------

    def _attend(self, q, k, v, mask, scale, quant: bool):
        """q [B, Tq, H, D], k/v [B, Tk, Hkv, D*], mask [B, Tq, Tk] ->
        [B, Tq, H, Dv]."""
        b, tq, h, d = q.shape
        hkv = k.shape[2]
        g = h // hkv
        qg = (q * scale).reshape(b, tq, hkv, g, d).permute(0, 2, 3, 1, 4) \
            .reshape(b, hkv, g * tq, d)
        kt = k.permute(0, 2, 3, 1)                             # [B,Hkv,D,Tk]
        vt = v.permute(0, 2, 1, 3)                             # [B,Hkv,Tk,Dv]
        s = qmatmul(qg, kt, self.bits) if quant else qg @ kt
        s = s.reshape(b, hkv, g, tq, -1)
        s = torch.where(mask[:, None, None], s, torch.full((), -1e30,
                                                           device=s.device))
        pr = torch.softmax(s, dim=-1).reshape(b, hkv, g * tq, -1)
        o = qmatmul(pr, vt, self.bits) if quant else pr @ vt
        dv = v.shape[-1]
        return o.reshape(b, hkv, g, tq, dv).permute(0, 3, 1, 2, 4) \
            .reshape(b, tq, h, dv)

    def _attend_event(self, w, q, k, v, ev, cache):
        """One event's attention: its new keys and values (rows `ev["rows"]`
        at its positions) into `cache`, then its queries over the cache."""
        pos, rows = ev["pos"], ev["rows"]
        cache["k"][rows[:, None], pos] = k
        cache["v"][rows[:, None], pos] = v
        return self._attend(q, cache["k"][rows], cache["v"][rows], ev["mask"],
                            w["scale"], quant=ev["decode"] and self.bits > 0)

    def gqa_qkv(self, w, h, pos):
        """Queries, keys and values of rows h [N, d] at positions pos [N]:
        [N, 1, H, D] each, as one-token sequences."""
        a = w["attn"]
        q = rope(self.mm(h, a["wq"], a["wq_shape"])[:, None], pos[:, None],
                 self.theta)
        k = rope(self.mm(h, a["wk"], a["wk_shape"])[:, None], pos[:, None],
                 self.theta)
        v = self.mm(h, a["wv"], a["wk_shape"])[:, None]
        return q, k, v

    def mla_qkv(self, w, h, pos):
        """MLA's queries (nope and rope parts together), keys (decompressed
        nope part and the shared rotary part) and values of rows h [N, d]."""
        cfg = self.cfg
        nope, r = int(cfg["qk_nope_head_dim"]), int(cfg["kv_lora_rank"])
        a = w["attn"]
        q = self.mm(h, a["wq"], a["wq_shape"])                # [N,H,nope+rope]
        q = torch.cat([q[..., :nope],
                       rope(q[:, None, :, nope:], pos[:, None],
                            self.theta)[:, 0]], -1)
        kv_a = self.mm(h, a["w_kv_a"])
        c_kv = rmsnorm(kv_a[:, :r], a["kv_a_norm"], self.eps)
        k_rope = rope(kv_a[:, None, None, r:], pos[:, None], self.theta)[:, 0]
        k_nope = self.mm(c_kv, a["w_uk"], a["w_uk_shape"])      # [N,H,nope]
        v = self.mm(c_kv, a["w_uv"], a["w_uv_shape"])           # [N,H,v]
        k = torch.cat([k_nope, k_rope.expand(-1, k_nope.shape[1], -1)], -1)
        return q[:, None], k[:, None], v[:, None]

    def attention(self, w, xs, evs):
        """Every event's attention: the projections of all their rows
        together, then the events in order through the cache, then the
        output projection of all rows together."""
        sizes = [x.shape[0] * x.shape[1] for x in xs]
        h = torch.cat([x.reshape(-1, x.shape[-1]) for x in xs])
        pos = torch.cat([ev["pos"].reshape(-1) for ev in evs])
        qkv = (self.mla_qkv if self.mla else self.gqa_qkv)(w, h, pos)
        parts = [torch.split(t, sizes) for t in qkv]
        cache = w["cache"]
        outs = []
        for e, ev in enumerate(evs):
            b, t = xs[e].shape[0], xs[e].shape[1]
            q, k, v = (p[e].reshape((b, t) + p[e].shape[2:]) for p in parts)
            if not ev["decode"]:               # a prefill resets its slot
                for c in cache.values():
                    c[ev["rows"]] = 0
            outs.append(self._attend_event(w, q, k, v, ev, cache)
                        .reshape(b * t, -1))
        y = self.mm(torch.cat(outs), w["attn"]["wo"])
        return [part.reshape(x.shape) for part, x in
                zip(torch.split(y, sizes), xs)]

    # -- MLPs and MoE, every event together --------------------------------------

    def dense_mlp(self, w, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """SwiGLU over each event's rows xs[e] [N_e, d]."""
        m = w["mlp"]
        if not self.bits:
            x = torch.cat(xs)
            y = self.mm(F.silu(self.mm(x, m["w_gate"])) * self.mm(x, m["w_in"]),
                        m["w_out"])
            return list(torch.split(y, [len(t) for t in xs]))
        h = self._qlinear(xs, m["w_in"])
        g = self._qlinear(xs, m["w_gate"])
        return self._qlinear([F.silu(b) * a for a, b in zip(h, g)],
                             m["w_out"])

    def _qlinear(self, xs, w32):
        """Each event's xs[e] quantized with its own scale against the
        weight quantized once: one exact contraction for all rows."""
        qw, sw = quantize(w32, self.bits)
        qs = [quantize(x, self.bits) for x in xs]
        y = torch.cat([q for q, _ in qs]) @ qw
        return [part.float() * (s * sw) for part, (_, s) in
                zip(torch.split(y, [len(x) for x in xs]), qs)]

    def moe(self, w, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Top-k routing with capacity over each event's tokens xs[e]
        [N_e, d]; the kept choices of every event run grouped by expert."""
        cfg, m = self.cfg, w["mlp"]
        e, k = int(cfg["n_routed_experts"]), int(cfg["num_experts_per_tok"])
        sizes = [len(x) for x in xs]
        x = torch.cat(xs)
        logits = x @ m["router"]
        probs = torch.softmax(logits, dim=-1)
        wts, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        wts, idx = wts[:, :k], idx[:, :k]
        if cfg.get("norm_topk_prob"):
            wts = wts / torch.clamp(wts.sum(-1, keepdim=True), min=1e-9)
        keep = []
        start = 0
        for n in sizes:                    # capacity within each event
            cap = max(int(float(cfg["capacity_factor"]) * k * n / e), 1)
            flat = idx[start:start + n].reshape(-1)
            onehot = (flat[:, None] == torch.arange(e, device=x.device)).long()
            pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
            keep.append(start * k + (pos < cap).nonzero()[:, 0])
            start += n
        keep = torch.cat(keep)
        self.dropped += k * len(x) - len(keep)
        tok, ex, wk = keep // k, idx.reshape(-1)[keep], wts.reshape(-1)[keep]
        y = torch.zeros_like(x)
        for j in torch.unique(ex).tolist():
            sel = ex == j
            t = tok[sel]
            h = self.act(x[t]) @ self.w32(m["w_in"][j])
            g = self.act(x[t]) @ self.w32(m["w_gate"][j])
            out = self.act(F.silu(g) * h) @ self.w32(m["w_out"][j])
            y.index_add_(0, t, out * wk[sel][:, None])
        if "shared_in" in m:
            h = self.mm(x, m["shared_in"])
            g = self.mm(x, m["shared_gate"])
            y = y + self.mm(F.silu(g) * h, m["shared_out"])
        return list(torch.split(y, sizes))

    # -- the replay -------------------------------------------------------------

    def _layer_weights(self, layer) -> Dict[str, Any]:
        """One layer's weights as float32 matrices in this precision (the
        routed experts stay as they are, taken one expert at a time)."""
        a = layer["attn"]
        out = {"ln1": layer["ln1"]["scale"], "ln2": layer["ln2"]["scale"],
               "cache": self._cache(layer)}
        if self.mla:
            out["attn"] = {"wq": self.w32(a["wq"]), "wq_shape": a["wq"].shape[1:],
                           "w_kv_a": self.w32(a["w_kv_a"]),
                           "kv_a_norm": a["kv_a_norm"]["scale"],
                           "w_uk": self.w32(a["w_uk"]),
                           "w_uk_shape": a["w_uk"].shape[1:],
                           "w_uv": self.w32(a["w_uv"]),
                           "w_uv_shape": a["w_uv"].shape[1:],
                           "wo": self.w32(a["wo"], 2)}
            out["scale"] = 1.0 / math.sqrt(int(self.cfg["qk_nope_head_dim"])
                                           + int(self.cfg["qk_rope_head_dim"]))
        else:
            out["attn"] = {"wq": self.w32(a["wq"]), "wq_shape": a["wq"].shape[1:],
                           "wk": self.w32(a["wk"]), "wv": self.w32(a["wv"]),
                           "wk_shape": a["wk"].shape[1:],
                           "wo": self.w32(a["wo"], 2)}
            out["scale"] = 1.0 / math.sqrt(a["wq"].shape[-1])
        m = layer["mlp"]
        if "router" in m:
            out["mlp"] = {"router": m["router"].float(), "w_in": m["w_in"],
                          "w_gate": m["w_gate"], "w_out": m["w_out"]}
            for name in ("shared_in", "shared_gate", "shared_out"):
                if name in m:
                    out["mlp"][name] = self.w32(m[name])
        else:
            out["mlp"] = {n: self.w32(m[n]) for n in ("w_in", "w_gate", "w_out")}
        return out

    def _cache(self, layer) -> Dict[str, torch.Tensor]:
        """One layer's keys and values for every slot (MLA's decompressed
        from the latent: per-head nope and rotary keys, values)."""
        s, t, a = self.slots, self.max_len, layer["attn"]
        if self.mla:
            h = a["wq"].shape[1]
            shapes = {"k": (s, t, h, a["wq"].shape[2]),
                      "v": (s, t, h, a["w_uv"].shape[2])}
        else:
            hd = a["wk"].shape[-1]
            shapes = {"k": (s, t, self.n_kv, hd), "v": (s, t, self.n_kv, hd)}
        return {k: torch.zeros(v, device=self.device) for k, v in shapes.items()}

    def _event(self, ev, prompts):
        """An engine event as the reference's inputs: tokens [B, T],
        positions, cache rows, the attention mask over the cache."""
        dev = self.device
        if ev["kind"] == "p":
            t = len(prompts[ev["rid"]])
            mask = torch.zeros((1, t, self.max_len), dtype=torch.bool,
                               device=dev)
            mask[0, :, :t] = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                                   device=dev))
            return {"tok": torch.tensor([prompts[ev["rid"]]], device=dev),
                    "pos": torch.arange(t, device=dev)[None], "mask": mask,
                    "rows": torch.tensor([ev["slot"]], device=dev),
                    "decode": False}
        s = self.slots
        pos = torch.tensor(ev["positions"], device=dev).reshape(s, 1)
        return {"tok": ev["tokens"].reshape(s, 1).to(dev).long(), "pos": pos,
                "mask": torch.arange(self.max_len, device=dev)[None, None]
                <= pos[:, :, None],
                "rows": torch.arange(s, device=dev), "decode": True}

    @torch.no_grad()
    def replay(self, events, prompts, every_position: bool = False
               ) -> List[torch.Tensor]:
        """Each event's final-normed hidden states at its last position:
        [1, d] for a prefill, [slots, d] for a decode step; with
        `every_position`, a prefill's at each of its positions [T, d]."""
        evs = [self._event(ev, prompts) for ev in events]
        xs = [self.w["embed"]["table"][ev["tok"]].float() for ev in evs]
        for i, layer in enumerate(self.w["layers"]):
            w = self._layer_weights(layer)
            ys = self.attention(w, [rmsnorm(x, w["ln1"], self.eps)
                                    for x in xs], evs)
            xs = [x + y for x, y in zip(xs, ys)]
            h2 = [rmsnorm(x, w["ln2"], self.eps).reshape(-1, x.shape[-1])
                  for x in xs]
            ffn = self.moe if self.has_moe and i >= self.first_dense \
                else self.dense_mlp
            xs = [x + y.reshape(x.shape) for x, y in zip(xs, ffn(w, h2))]
            del w
        scale = self.w["final_norm"]["scale"]
        if every_position:
            return [rmsnorm(x[0], scale, self.eps) for x in xs]
        return [rmsnorm(x[:, -1], scale, self.eps) for x in xs]

    @torch.no_grad()
    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Logits over the vocabulary of final-normed rows h [N, d]."""
        return self.mm(h, self.w32(self.w["lm_head"]["w"]))[..., :self.vocab]


def reference_for(cfg: Dict[str, Any], weights, slots: int, max_len: int,
                  precision: str) -> Decoder:
    return Decoder(cfg, weights, slots, max_len, precision)
