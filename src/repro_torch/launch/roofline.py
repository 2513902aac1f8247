"""Roofline-term extraction for the dry run.

Port of `repro.launch.roofline`. Three terms per (arch x shape x mesh), in
seconds, from a shared `repro_torch.cim.cost.DeviceSpec` (default: the
port's row, one NVIDIA H100 SXM: 989e12 bf16 FLOP/s, 3.35e12 B/s HBM,
450e9 B/s NVLink; another target is one CSV row away via
`DeviceSpec.from_csv`):

  compute    = FLOPs_global      / (chips * peak_flops)
  memory     = bytes_global      / (chips * hbm_bw)
  collective = collective_bytes  / ici_bw

The reference reads FLOPs and bytes from XLA's `cost_analysis` and
collective bytes from the partitioned HLO text. The port has no XLA: its
dry run (`repro_torch.launch.dryrun`) counts one traced step's FLOPs with
`torch.utils.flop_counter` and sums the operand bytes of every collective
the step issues into the same `CollectiveStats`. `collective_bytes`, the
HLO text parser, is kept as text functions with the reference's cases.
`RooflineTerms.to_dict()["device"]` names the port's device row
("h100-sxm" where the reference says "tpu-v5e"), by design.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

from repro_torch.cim.cost import DEFAULT_DEVICE, DeviceSpec
from repro_torch.tree import walk

#: module-level aliases kept for callers that predate DeviceSpec
PEAK_FLOPS = DEFAULT_DEVICE.peak_flops   # bf16 per card
HBM_BW = DEFAULT_DEVICE.hbm_bw           # B/s per card
ICI_BW = DEFAULT_DEVICE.ici_bw           # B/s per card (one NVLink link)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: element widths in BITS — s4/u4 are sub-byte, so per-element byte widths
#: would be fractional; accumulate bits per instruction and round ONCE (the
#: same convention as the PR-4 offload estimator fix)
_DTYPE_BITS = {
    "pred": 8, "s4": 4, "u4": 4, "s8": 8, "u8": 8, "s16": 16, "u16": 16,
    "s32": 32, "u32": 32, "s64": 64, "u64": 64, "f8e4m3fn": 8, "f8e5m2": 8,
    "bf16": 16, "f16": 16, "f32": 32, "f64": 64, "c64": 64, "c128": 128,
    "token": 0, "opaque": 0,
}

_SHAPE_RE = re.compile(r"([a-z][a-z0-9]*)\[([0-9,]*)\]")
# instruction: [ROOT] %name = <shape-or-tuple> opcode(
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?(%?[\w.\-]+)\s*=\s*(\([^=]*?\)|[a-z][a-z0-9]*\[[0-9,]*\](?:\{[^}]*\})?)\s+([\w\-]+)",
)


def _shape_bytes(shape_str: str) -> int:
    """Byte size of one instruction's output shape (tuples summed), rounded
    up from exact bit totals once per instruction — an s4[7] is 4 bytes,
    never a fractional 3.5 leaking into the symbol table."""
    bits = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BITS:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        bits += n * _DTYPE_BITS[dt]
    return -(-bits // 8)


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, float]
    count_by_op: Dict[str, int]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_op.values())


def collective_bytes(hlo_text: str) -> CollectiveStats:
    """Sum operand sizes of every collective in (partitioned) HLO text."""
    sizes: Dict[str, float] = {}
    by_op: Dict[str, float] = {c: 0.0 for c in COLLECTIVES}
    counts: Dict[str, int] = {c: 0 for c in COLLECTIVES}

    lines = hlo_text.splitlines()
    # pass 1: symbol table  name -> output bytes
    for ln in lines:
        m = _INSTR_RE.match(ln)
        if m:
            name = m.group(1).lstrip("%")
            sizes[name] = _shape_bytes(m.group(2))

    # pass 2: collectives — sum operand bytes
    for ln in lines:
        m = _INSTR_RE.match(ln)
        if not m:
            continue
        op = m.group(3)
        base = None
        for c in COLLECTIVES:
            if op == c or op.startswith(c + "-start") or op == c + "-done":
                base = c
                break
        if base is None:
            continue
        if op.endswith("-done"):
            continue  # avoid double counting start/done pairs
        # operand list: first (...) after the opcode
        rest = ln[m.end():]
        paren = rest.find("(")
        if paren < 0:
            continue
        depth, j = 0, paren
        for j in range(paren, len(rest)):
            if rest[j] == "(":
                depth += 1
            elif rest[j] == ")":
                depth -= 1
                if depth == 0:
                    break
        args = rest[paren + 1 : j]
        total = 0.0
        for tok in re.finditer(r"%?([\w.\-]+)", args):
            nm = tok.group(1)
            if nm in sizes:
                total += sizes[nm]
        by_op[base] += total
        counts[base] += 1
    return CollectiveStats(bytes_by_op=by_op, count_by_op=counts)


@dataclasses.dataclass
class RooflineTerms:
    flops_global: float
    bytes_global: float
    collective_bytes_per_chip: float
    n_chips: int
    model_flops: float
    device: Optional[DeviceSpec] = None    # DEFAULT_DEVICE when None

    @property
    def _dev(self) -> DeviceSpec:
        return self.device or DEFAULT_DEVICE

    @property
    def t_compute(self) -> float:
        return self.flops_global / (self.n_chips * self._dev.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.bytes_global / (self.n_chips * self._dev.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_chip / self._dev.ici_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / max(self.flops_global, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """useful-FLOPs time / achievable step time (max of the 3 terms):
        the headline 'fraction of roofline' figure."""
        t_useful = self.model_flops / (self.n_chips * self._dev.peak_flops)
        t_step = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / max(t_step, 1e-30)

    def to_dict(self) -> Dict[str, float]:
        return {
            "device": self._dev.name,
            "flops_global": self.flops_global,
            "bytes_global": self.bytes_global,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "n_chips": self.n_chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def active_param_count(cfg, params) -> float:
    """N_active for MODEL_FLOPS over the port's parameter tree (`meta`
    tensors do): excludes the embedding lookup table; routed expert tensors
    ([E, ., .] per layer) scaled by top_k / n_experts."""
    total = 0.0
    for path, leaf in walk(params):
        keys = "/".join(path)
        n = 1
        for d in leaf.shape:
            n *= d
        if keys.endswith("embed/table"):
            continue
        if cfg.moe is not None and ("/w_in" in keys or "/w_gate" in keys or "/w_out" in keys) \
                and len(leaf.shape) >= 3 and keys.startswith("layers/"):
            # per-layer moe expert weights: [E, ., .]
            if leaf.shape[-3] == cfg.moe.n_experts:
                n = n * cfg.moe.top_k / cfg.moe.n_experts
        total += n
    return total


def model_flops(cfg, params, shape) -> float:
    """6*N_active*tokens (train) / 2*N_active*tokens (inference)."""
    n_active = active_param_count(cfg, params)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


# ---------------------------------------------------------------------------
# Analytic FLOPs / bytes models
# ---------------------------------------------------------------------------
# The reference's XLA cost_analysis counts a scan body once, so it takes
# max(HLO, analytic) per term; the port's dry run keeps that rule with its
# traced figures in place of the HLO's, both recorded. The analytic model mirrors
# the actual lowered compute paths (blockwise attention, scatter-MoE with
# capacity, absorbed MLA, chunked recurrences, remat factor 4/3 on fwd).


def analytic_flops(cfg, shape) -> float:
    """Forward FLOPs from the layer composition; train = 4x fwd (remat)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        t = b                       # one token per sequence
        ctx = s                     # attended context
        s_sq = 0.0                  # no quadratic term
    else:
        t = b * s
        ctx = s
        s_sq = 0.5 * b * s * s      # causal half of the S^2 term

    d, h, kv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    fl = 0.0

    def attn_flops(window=0):
        x = 2.0 * t * d * (h + 2 * kv) * hd          # qkv proj
        x += 2.0 * t * h * hd * d                    # out proj
        if shape.kind == "decode":
            span = min(window, ctx) if window else ctx
            x += 2.0 * 2.0 * t * span * h * hd       # qk + av vs cache
        else:
            span_sq = (min(window, s) * s * b) if window else s_sq
            x += 2.0 * 2.0 * span_sq * h * hd
        return x

    def mla_flops():
        m = cfg.mla
        qd = m.qk_nope_dim + m.qk_rope_dim
        r = m.kv_lora_rank
        x = 2.0 * t * d * h * qd + 2.0 * t * d * (r + m.qk_rope_dim)
        if shape.kind == "decode":
            # ABSORBED form: score/combine via the latent (per-token q
            # absorption, no per-position decompression of the whole cache)
            x += 2.0 * t * h * m.qk_nope_dim * r
            x += 2.0 * t * ctx * h * (r + m.qk_rope_dim) + 2.0 * t * ctx * h * r
            x += 2.0 * t * h * r * m.v_head_dim
        else:
            # EXPLICIT form (prefill/train): decompress K/V once, attend in
            # (nope+rope)-dim heads — 5.7x fewer S^2 FLOPs than absorbed
            x += 2.0 * t * r * h * (m.qk_nope_dim + m.v_head_dim)
            x += 2.0 * s_sq * h * qd + 2.0 * s_sq * h * m.v_head_dim
        x += 2.0 * t * h * m.v_head_dim * d
        return x

    def mlp_flops(width):
        mults = 3 if cfg.gating in ("swiglu", "geglu") else 2
        return 2.0 * t * d * width * mults

    def moe_flops():
        m = cfg.moe
        x = 2.0 * t * d * m.n_experts                # router
        routed_tokens = m.capacity_factor * m.top_k * t
        x += 2.0 * routed_tokens * d * m.d_ff_expert * 3
        if m.n_shared:
            x += 2.0 * t * d * (m.d_ff_expert * m.n_shared) * 3
        return x

    def rec_flops():
        dr = d
        x = 2.0 * 2.0 * t * d * dr + 2.0 * 2.0 * t * dr * dr
        x += t * dr * 14.0                           # conv4 + gates + recurrence
        x += 2.0 * t * dr * d
        return x

    def mlstm_flops():
        di = int(2.0 * d)
        dh_i = di // h
        x = 2.0 * t * d * di + 2.0 * t * di * 3 * di + 2.0 * t * di * 3 * h
        x += 6.0 * t * di * dh_i                     # C update + read per token
        x += 2.0 * t * di * d
        return x

    def slstm_flops():
        df = int(4.0 / 3.0 * d)
        return 2.0 * t * d * 4 * d * 2 + 2.0 * t * d * df * 3

    kinds = list(cfg.pattern_layers())
    for li, kind in enumerate(kinds):
        if kind == "attn":
            fl += mla_flops() if cfg.mla else attn_flops()
            if cfg.moe is not None and li >= cfg.first_dense_layers:
                fl += moe_flops()
            else:
                fl += mlp_flops(cfg.d_ff_first_dense or f)
        elif kind == "local":
            fl += attn_flops(window=cfg.local_window)
            fl += moe_flops() if (cfg.moe is not None) else mlp_flops(f)
        elif kind == "rec":
            fl += rec_flops() + mlp_flops(f)
        elif kind == "mlstm":
            fl += mlstm_flops()
        elif kind == "slstm":
            fl += slstm_flops()
    fl += 2.0 * t * d * cfg.vocab_size               # lm head
    if shape.kind == "train":
        fl *= 4.0                                    # fwd + bwd(2x) + remat fwd
    return fl


def analytic_bytes(cfg, shape, params_bytes: float, cache_bytes: float) -> float:
    """First-order HBM traffic (global, bytes) per step.

    train:  params+grads+opt read/write (8x P: p r/w, m r/w, v r/w, grad r/w)
            + activation save/reload at chunk boundaries
    prefill: params once + activations + cache write
    decode:  params once + full cache read + write of the new slot
    """
    b, s = shape.global_batch, shape.seq_len
    act_elt = 2.0  # bf16
    l, d = cfg.n_layers, cfg.d_model
    if shape.kind == "train":
        acts = 10.0 * b * s * d * l * act_elt
        return 8.0 * params_bytes + acts
    if shape.kind == "prefill":
        acts = 6.0 * b * s * d * l * act_elt
        return params_bytes + acts + cache_bytes
    return params_bytes + cache_bytes + 4.0 * b * d * l * act_elt
