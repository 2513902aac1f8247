"""Model assembly for every family of the registry: parameters, caches,
and the train, prefill and decode paths.

Port of `repro.models.model` for layer kinds `attn` (global attention:
GQA/MQA, or DeepSeek-V2's MLA when the config has `mla`), `local`
(sliding-window attention with a ring-buffer cache) and `rec` (the Griffin
RG-LRU block), each followed by an MLP or, past the config's
`first_dense_layers`, a Mixture-of-Experts layer (`moe.py`); and `mlstm` /
`slstm` (the xLSTM blocks: `x + cell(rmsnorm(x))`, no MLP). Embed-stub
configs (audio, VLM) read precomputed `embeds` instead of tokens. The
reference stacks its layers per pattern period and scans over them,
unrolling the scan for serving (`cim_unroll_groups`) and memoizing
per-group parameter slices so the same arrays reach every call
(`Model._group_param_slices`). The port is an `nn.Module` with one module
per layer in the reference's stack order (the `first_dense` prefix, then
the pattern repeated, then the remainder: `stack_kinds`), so every layer
always receives the same parameter tensors; the compute-dtype casts of
prefill and decode (`_compute_cast`, bf16 at full width; the MoE `router`
stays float32) are memoized per parameter for the same reason: resident
weight pins are keyed by tensor identity and stay warm across calls.

A model built for serving (`build(..., for_serving=True)`, which the
serve entry point uses) holds each layer weight that the cast would
convert only as its compute-dtype copy: drawn in float32, cast at once,
layer by layer, so no float32 copy of the whole model exists and `_cast`
returns the tensor itself. The embedding table, `lm_head`, norm scales and
routers stay float32, as the reference computes with them. The values, and
so tokens, logits and counts, are those of the float32-master model.

The train path (`forward`, `loss`: `_train_stack`) runs every layer
kind, MLA and MoE included. Its compute-dtype cast is a fresh,
differentiable `t.to(act)` on every call (the memoized casts are
detached), and under `cfg.remat` each layer runs under
`torch.utils.checkpoint`, where the reference checkpoints each pattern
period (period 1 for the `attn` stacks; a finer cut of the hybrid's and
xLSTM's periods, the same values). The recurrences train through
`kernels.ops`: on the card the RG-LRU and sLSTM kernels' forward, with a
backward that reruns their plain versions under autograd, as the
reference differentiates its jnp scans. One departure: the reference's
train forward calls `gqa_apply` without `use_flash`
(`src/repro/models/model.py:153`),
so it attends through the dense `_sdpa` or the jnp blockwise form, and its
Pallas flash kernel covers real-TPU execution; on the card the port plays
the TPU's role, so its train forward calls `gqa_apply(use_flash=True)`:
the CUDA flash kernel forward, the blockwise backward. Both compute the
same function and are held to each other. MLA trains as the reference's
`mla_apply` does (its q/k and v widths differ); sliding-window layers
attend through `local_apply` (dense or blockwise), as the reference's.
MoE layers add their load-balancing loss: `loss = ce + 0.01 * aux`.

On a mesh (`repro_torch.sharding.distribute_model`) the parameters are
DTensors placed by the reference's specs and a step runs on each dp rank's
rows. Every weight the specs shard on "model" runs tensor-parallel,
Megatron's way: each rank gathers its "model" block over the dp axes only
(`_tp_cast`) and the blocks are joined by the fewest collectives of
`sharding.rules` (`tp_enter`/`tp_exit`, `tp_sum`, `tp_gather`,
`tp_scatter`). The embedding and head are vocab-parallel (each rank looks
up its vocab block's tokens; the CE sums its max, exponentials and target
logit over the blocks; `logits()` gathers whole rows for sampling). Dense
MLPs and MoE experts split their hidden dim ("tp" expert sharding; "ep"
expert weights are gathered whole at their use, as the reference's are).
Attention splits by head, or by head_dim where the heads do not divide
(partial scores summed by one all-reduce); MLA by head, or by its feature
dims; the RG-LRU block by channel, its scan on the kernel at the rank's
[B, T, D/m]. Caches keep `cache_specs`' layout: each rank holds its rows
and its "model" block of the feature dim (head_dim, the MLA latent and
rope widths, the recurrent width), and decode attention sums its partial
scores over the blocks (`attention.gqa_decode_tp`). Weights the specs
place whole over "model" (norms, MLA's w_kv_a, routers) are gathered whole
(`_shared`, `_cast`); besides "ep" experts, the one "model"-sharded
weight gathered whole is the key/value weight that attention split by
head reads across kv groups (one kv head split by head_dim: gemma-2b's,
the hybrid's). Where `_fit`
dropped "model" from a spec, and for the xLSTM cells, the CiM MLPs and CiM
decode attention, the layer runs whole on every "model" rank. The
activation between train layers is a DTensor under the reference's hint
(batch on the dp axes, sequence on "model", gathered again at each layer's
input), a MoE layer gathers its batch over the dp axes and keeps its own
rows of the output (routing is global, as the reference's), and batches
are taken to this rank's rows. Everything in a layer (the kernels'
autograd Functions included) runs on plain local tensors.

The prefill runs eagerly, so its CiM MLPs charge the ledger on every call
(the reference's jitted prefill charges once at trace time), and it never
pins weights (residency is off under the reference's jit tracers too).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.cim.array import ArraySpec
from repro_torch.configs.base import ArchConfig
from repro_torch.sharding import rules as shard_rules
from . import attention as attn
from . import moe as moe_lib
from . import recurrent as rec_lib
from . import xlstm as xlstm_lib
from .layers import (
    chunked_lm_loss,
    embed,
    embed_init,
    hint_activation_sharding,
    lm_head_init,
    mlp,
    mlp_cim,
    mlp_init,
    _mlp_quantized,
    rmsnorm,
    rmsnorm_init,
)

Params = Dict[str, Any]

#: the layer kinds this port runs
LAYER_KINDS = ("attn", "local", "rec", "mlstm", "slstm")
#: the xLSTM kinds: one cell after ln1, no ln2 and no MLP
XLSTM_CELLS = {"mlstm": (xlstm_lib.mlstm_init, xlstm_lib.mlstm_apply,
                         xlstm_lib.mlstm_make_state),
               "slstm": (xlstm_lib.slstm_init, xlstm_lib.slstm_apply,
                         xlstm_lib.slstm_make_state)}


#: leaves the compute cast keeps in float32 (the reference's `_KEEP_F32`:
#: routing logits stay full precision)
KEEP_F32 = ("router",)


def stack_kinds(cfg: ArchConfig) -> tuple:
    """Per-layer kinds in the reference's stack order: the `first_dense`
    prefix (global attention with a dense MLP), then the block pattern over
    the remaining layers (its groups, then the remainder)."""
    fd, p = cfg.first_dense_layers, cfg.block_pattern
    return ("attn",) * fd + tuple(p[i % len(p)]
                                  for i in range(cfg.n_layers - fd))


@dataclasses.dataclass(frozen=True)
class StackLayout:
    """The stack as the reference counts it: the block pattern, the
    `first_dense` prefix, the pattern's whole groups over the layers after
    it and the remainder (`stack_kinds` lists the same layers one by one)."""

    pattern: Tuple[str, ...]
    n_first_dense: int
    n_groups: int
    n_rem: int

    @classmethod
    def from_config(cls, cfg: ArchConfig) -> "StackLayout":
        p = cfg.block_pattern
        body = cfg.n_layers - cfg.first_dense_layers
        return cls(pattern=p, n_first_dense=cfg.first_dense_layers,
                   n_groups=body // len(p), n_rem=body % len(p))


def is_moe_layer(cfg: ArchConfig, index: int) -> bool:
    """Whether layer `index` (of `stack_kinds`) carries a MoE MLP."""
    return cfg.moe is not None and index >= cfg.first_dense_layers


def dense_mlp_width(cfg: ArchConfig, kind: str) -> int:
    """d_ff of a dense MLP: attention layers take `d_ff_first_dense` when
    the config sets one (DeepSeek's dense layer 0), as the reference."""
    return cfg.d_ff if kind == "rec" else (cfg.d_ff_first_dense or cfg.d_ff)


def _cast_rule(name: str, t: torch.Tensor, act) -> bool:
    """The reference's `_compute_cast` condition for one leaf."""
    return (act != torch.float32 and t.dtype == torch.float32
            and t.dim() >= 2 and name not in KEEP_F32)


def _to_compute(tree: Params, act) -> Params:
    """A freshly drawn layer's weights that the compute cast converts, cast
    once and the float32 draw dropped (leaves named as `_compute_cast`
    names them: the last key)."""
    out: Params = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out[name] = _to_compute(v, act)
        else:
            out[name] = v.to(act) if _cast_rule(name, v, act) else v
    return out


def _layer_init(gen, cfg: ArchConfig, kind: str, index: int, dtype,
                device) -> Params:
    p: Params = {"ln1": rmsnorm_init(cfg.d_model, dtype, device)}
    if kind in XLSTM_CELLS:
        p["cell"] = XLSTM_CELLS[kind][0](gen, cfg, dtype, device)
        return p
    if kind == "rec":
        p["rec"] = rec_lib.rglru_block_init(gen, cfg, dtype, device)
    elif cfg.mla is not None:
        p["attn"] = attn.mla_init(gen, cfg, dtype, device)
    else:
        p["attn"] = attn.gqa_init(gen, cfg, dtype, device)
    p["ln2"] = rmsnorm_init(cfg.d_model, dtype, device)
    if kind != "rec" and is_moe_layer(cfg, index):
        p["mlp"] = moe_lib.moe_init(gen, cfg, dtype, device)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, dense_mlp_width(cfg, kind),
                            cfg.gating, dtype, device)
    return p


def init_params(cfg: ArchConfig, gen: torch.Generator, device,
                for_serving: bool = False) -> Params:
    """Random parameters with the reference's init distributions, from an
    explicit generator: {"embed", "layers": [...], "final_norm"[, "lm_head"]}.
    `for_serving` keeps each layer's cast weights only in the compute dtype
    (the draws, and so the values, are the same)."""
    dtype = cfg.param_torch_dtype()
    kinds = stack_kinds(cfg)
    unknown = sorted(set(kinds) - set(LAYER_KINDS))
    if unknown:
        raise NotImplementedError(f"{cfg.name}: layer kinds {unknown}; the "
                                  f"port runs {LAYER_KINDS}")
    act = cfg.activation_dtype()
    params: Params = {}
    if not cfg.embed_stub:
        params["embed"] = embed_init(gen, cfg.vocab_padded, cfg.d_model,
                                     dtype, device)
    params["layers"] = []
    for i, kind in enumerate(kinds):
        p = _layer_init(gen, cfg, kind, i, dtype, device)
        params["layers"].append(_to_compute(p, act) if for_serving else p)
    params["final_norm"] = rmsnorm_init(cfg.d_model, dtype, device)
    if not (cfg.tie_embeddings and not cfg.embed_stub):
        params["lm_head"] = lm_head_init(gen, cfg.d_model, cfg.vocab_padded,
                                         dtype, device)
    return params


def _param(v: torch.Tensor) -> nn.Parameter:
    return v if isinstance(v, nn.Parameter) else \
        nn.Parameter(v, requires_grad=False)


def _pdict(d: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: _param(v) for k, v in d.items()})


class Layer(nn.Module):
    """One block's parameters: ln1, its mixer ("attn" or "rec"), ln2 and
    mlp; or ln1 and an xLSTM "cell". A sub-tree of tensors becomes a
    ParameterDict; one that nests further (the cell's norms) a Layer."""

    def __init__(self, p: Params):
        super().__init__()
        self.names = tuple(p)
        for name, v in p.items():
            if not isinstance(v, dict):
                setattr(self, name, _param(v))
            elif any(isinstance(x, dict) for x in v.values()):
                setattr(self, name, Layer(v))
            else:
                setattr(self, name, _pdict(v))

    def tree(self) -> Params:
        out: Params = {}
        for name in self.names:
            v = getattr(self, name)
            out[name] = (v.tree() if isinstance(v, Layer) else
                         dict(v.items()) if isinstance(v, nn.ParameterDict)
                         else v)
        return out


class Model(nn.Module):
    """The decoder for one ArchConfig, its parameters on one device.

    Without `params` it initialises random ones from `seed` on `device`
    (`cuda` unless the caller passes `device="cpu"`; raises without a GPU;
    on `meta` it draws nothing: the dry run's parameters).
    `for_serving` holds the cast layer weights in the compute dtype only
    (see the module docstring). `resident_spec` is the ArraySpec whose
    registry ResidentSet holds the decode weight pins (None: the paper's
    DEFAULT_SPEC)."""

    def __init__(self, cfg: ArchConfig, params: Optional[Params] = None,
                 device=None, seed: int = 0,
                 resident_spec: Optional[ArraySpec] = None,
                 for_serving: bool = False,
                 _cast_cache: Optional[dict] = None):
        super().__init__()
        self.cfg = cfg
        self.kinds = stack_kinds(cfg)
        self.resident_spec = resident_spec
        if params is None:
            device = resolve_device(device)
            # `meta` (the dry run): shapes and dtypes only, no draws
            gen = None if device.type == "meta" else \
                torch.Generator(device=device).manual_seed(seed)
            params = init_params(cfg, gen, device, for_serving)
        if "embed" in params:
            self.embed = _pdict(params["embed"])
        self.layers = nn.ModuleList(Layer(p) for p in params["layers"])
        self.final_norm = _pdict(params["final_norm"])
        if "lm_head" in params:
            self.lm_head = _pdict(params["lm_head"])
        # id(param) -> (param, compute-dtype copy); shared with derived models
        self._cast_cache = {} if _cast_cache is None else _cast_cache
        # the DeviceMesh its parameters are DTensors on
        # (`repro_torch.sharding.distribute_model`), else None
        self.mesh = None

    @property
    def device(self) -> torch.device:
        return self.final_norm["scale"].device

    def params(self) -> Params:
        """The parameter tree (the same Parameter objects the model uses)."""
        out: Params = {"layers": [layer.tree() for layer in self.layers],
                       "final_norm": dict(self.final_norm.items())}
        if hasattr(self, "embed"):
            out["embed"] = dict(self.embed.items())
        if hasattr(self, "lm_head"):
            out["lm_head"] = dict(self.lm_head.items())
        return out

    def derive(self, cfg: ArchConfig,
               resident_spec: Optional[ArraySpec] = None) -> "Model":
        """A model under another config (and resident array, else this
        one's) sharing these very parameters and their memoized casts."""
        return Model(cfg, params=self.params(),
                     resident_spec=resident_spec or self.resident_spec,
                     _cast_cache=self._cast_cache)

    # -- caches / casts -------------------------------------------------------

    def init_caches(self, batch: int, max_len: int) -> List[Params]:
        cfg, dtype, dev = self.cfg, self.cfg.activation_dtype(), self.device
        out = []
        for kind in self.kinds:
            if kind in XLSTM_CELLS:
                out.append(XLSTM_CELLS[kind][2](cfg, batch, dev))
            elif kind == "rec":
                out.append(rec_lib.rglru_make_state(cfg, batch, dtype, dev))
            elif kind == "local":
                out.append(attn.local_make_cache(cfg, batch, dtype, dev))
            elif cfg.mla is not None:
                out.append(attn.mla_make_cache(cfg, batch, max_len, dtype,
                                               dev))
            else:
                out.append(attn.gqa_make_cache(cfg, batch, max_len, dtype,
                                               dev))
        return out

    def _cast(self, t: torch.Tensor, name: str = "") -> torch.Tensor:
        """The reference's `_compute_cast` of leaf `name`: f32 weights of
        rank >= 2 other than the router in the activation dtype, memoized
        so the same tensor comes back each call. A DTensor parameter is
        gathered at its use and cast each call (nothing memoized)."""
        if shard_rules.is_dtensor(t):
            return self._train_cast(t, name)
        if not _cast_rule(name, t, self.cfg.activation_dtype()):
            return t
        hit = self._cast_cache.get(id(t))
        if hit is None or hit[0] is not t:
            hit = self._cast_cache[id(t)] = (
                t, t.detach().to(self.cfg.activation_dtype()))
        return hit[1]

    def _train_cast(self, t: torch.Tensor, name: str = "") -> torch.Tensor:
        """`_compute_cast` for the train path: a fresh cast on every call,
        so gradients reach the float32 master weights (a DTensor parameter
        gathered first: `sharding.rules.gather_param`)."""
        act = self.cfg.activation_dtype()
        t = shard_rules.gather_param(t)
        return t.to(act) if _cast_rule(name, t, act) else t

    def _whole(self, p: Params) -> Params:
        """A non-layer parameter dict (embed, final norm, head) with each
        DTensor gathered at its use."""
        return {k: shard_rules.gather_param(v) for k, v in p.items()}

    def _layer_params(self, layer: Layer, train: bool = False) -> Params:
        raw = layer.tree()
        return {k: self._cast_part(raw, k, train) for k in raw}

    def _cast_part(self, raw: Params, name: str, train: bool = False):
        """Leaf or sub-tree `name` of a layer's parameters cast for compute
        (each DTensor gathered whole at its use)."""
        one = self._train_cast if train else self._cast

        def cast(tree):
            return {k: cast(v) if isinstance(v, dict) else one(v, k)
                    for k, v in tree.items()}
        v = raw[name]
        return cast(v) if isinstance(v, dict) else one(v, name)

    # -- tensor parallelism over "model" --------------------------------------

    def _tp_on(self) -> bool:
        """Whether the model's mesh has more than one "model" rank."""
        return shard_rules.model_parallel(self.mesh) > 1

    def _feature_split(self, width: int) -> bool:
        """Whether a cache leaf `width` wide in its last dim is split over
        "model" (`cache_specs` places it so where the axis divides it)."""
        m = shard_rules.model_parallel(self.mesh)
        return m > 1 and width % m == 0

    def _tp_cast(self, t: torch.Tensor, name: str, dim: int) -> torch.Tensor:
        """This rank's "model" block of weight `name` (its dim `dim`),
        gathered over the dp axes and cast for compute."""
        t = shard_rules.gather_param_tp(t, dim)
        act = self.cfg.activation_dtype()
        return t.to(act) if _cast_rule(name, t, act) else t

    def _shared(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """A weight placed whole over "model" that a tensor-parallel
        region reads (norms, MLA's w_kv_a): gathered over the dp axes,
        each rank's gradient a share summed over "model" too."""
        t = shard_rules.gather_param(t, partial_model=True)
        act = self.cfg.activation_dtype()
        return t.to(act) if _cast_rule(name, t, act) else t

    def _tp_weights(self, p: Params, dims: Dict[str, int]) -> Params:
        """p's leaves in `dims` as this rank's blocks, norm sub-trees and
        the other leaves whole (`_shared`)."""
        out: Params = {}
        for k, v in p.items():
            if isinstance(v, dict):
                out[k] = {n: self._shared(t, n) for n, t in v.items()}
            elif k in dims:
                out[k] = self._tp_cast(v, k, dims[k])
            else:
                out[k] = self._shared(v, k)
        return out

    def _mlp_tp(self, p: Params, h: torch.Tensor) -> Optional[torch.Tensor]:
        """A dense MLP run tensor-parallel over "model" (column-parallel
        w_in/w_gate, row-parallel w_out, one all-reduce of the float32
        output), or None where the specs do not shard it so (or it is a
        CiM MLP): the caller then gathers it whole."""
        dims = {k: d for k, d in (("w_in", 1), ("w_gate", 1), ("w_out", 0))
                if k in p}
        if self.cfg.cim_mlp_bits or not all(
                shard_rules.tp_sharded(p[k], d) for k, d in dims.items()):
            return None
        w = {k: self._tp_cast(p[k], k, d) for k, d in dims.items()}
        mesh = self.mesh
        return mlp(w, shard_rules.tp_enter(h, mesh), self.cfg.gating,
                   reduce=lambda y: shard_rules.tp_exit(y, mesh))

    def _attn_tp(self, p: Params, h, positions, kind: str, mode: str,
                 cache=None, max_len=None):
        """GQA attention (global or sliding-window) run tensor-parallel
        over "model" in any mode: (y, new cache or None), or None where
        the specs split wq and wo neither by head nor by head_dim (or a
        rank's query heads would straddle key/value groups, or the caches
        are not split, or decode attention is CiM): the caller then runs
        the layer whole.

        By head (wq, wo): this rank's query heads and the key/value heads
        they read, from wk/wv's blocks of kv heads or, where the specs
        split those by head_dim, gathered whole in train and prefill (the
        one weight a rank gathers whole, as GSPMD does); prefill keeps the
        head_dim block of every kv head for the cache. By head_dim: every
        weight's block, partial scores summed over the ranks. Decode runs
        on the cache's head_dim block either way
        (`attention.gqa_decode_tp`)."""
        cfg, mesh = self.cfg, self.mesh
        sh = shard_rules.tp_sharded
        heads = sh(p["wq"], 1) and sh(p["wo"], 0)
        head_dim = all(sh(p[k], d) for k, d in (("wq", 2), ("wk", 2),
                                                  ("wv", 2), ("wo", 1)))
        if not (heads or head_dim) or (
                mode != "train" and not self._feature_split(cfg.head_dim)):
            return None
        if mode == "decode" and cfg.cim_attention_bits:
            return None
        kv_heads = sh(p["wk"], 1) and sh(p["wv"], 1)
        hq = cfg.n_heads // shard_rules.model_parallel(mesh)
        group = cfg.n_heads // cfg.n_kv_heads
        kv_whole = heads and not kv_heads and mode != "decode"
        if kv_whole and hq % group and group % hq:
            return None
        dims = {"wq": 1, "wo": 0} if heads else {"wq": 2, "wo": 1}
        if not kv_whole:
            dims.update({"wk": 1, "wv": 1} if kv_heads else
                        {"wk": 2, "wv": 2})
        w = self._tp_weights(p, dims)
        window = cfg.local_window if kind == "local" else 0
        if mode == "decode":
            return attn.gqa_decode_tp(w, cfg, h, cache, positions, mesh,
                                      window)
        if head_dim:
            y, kv = attn.gqa_head_dim_tp(w, cfg, h, positions, mesh, window)
        else:
            y, kv = attn.gqa_heads_tp(
                w, cfg, h, positions, mesh, window,
                use_flash=mode == "train" and kind != "local",
                kv_whole=kv_whole, keep_kv=mode == "prefill")
        if mode == "train":
            return y, None
        return y, (attn._ring_cache(*kv, window) if window else
                   attn._dense_cache(*kv, max_len))

    def _mla_tp(self, p: Params, h, positions, mode: str, cache=None,
                max_len=None):
        """MLA run tensor-parallel over "model": (y, new cache or None), or
        None where the specs split neither its heads nor its feature dims
        (or the latent caches are not split). By head: wq, w_uk, w_uv
        and wo's rows by head, w_kv_a and the latent whole on every rank
        (`attention.mla_heads_tp`, `mla_decode_heads_tp`); by feature dim
        (heads not divisible by "model"): `attention.mla_head_dim_tp`."""
        cfg, m = self.cfg, self.cfg.mla
        sh = shard_rules.tp_sharded
        heads = all(sh(p[k], d) for k, d in (("wq", 1), ("w_uk", 1),
                                              ("w_uv", 1), ("wo", 0)))
        feat = all(sh(p[k], d) for k, d in (("wq", 2), ("w_uk", 0),
                                             ("w_uv", 0), ("wo", 1)))
        if not (heads or feat) or (mode != "train" and not (
                self._feature_split(m.kv_lora_rank)
                and self._feature_split(m.qk_rope_dim))):
            return None
        w = self._tp_weights(p, {"wq": 1, "w_uk": 1, "w_uv": 1, "wo": 0}
                             if heads else
                             {"wq": 2, "w_uk": 0, "w_uv": 0, "wo": 1})
        mesh = self.mesh
        if feat:
            y, kv = attn.mla_head_dim_tp(w, cfg, h, positions, mesh,
                                         cache if mode == "decode" else None)
        elif mode == "decode":
            y, kv = attn.mla_decode_heads_tp(w, cfg, h, cache, positions,
                                             mesh)
        else:
            y, kv = attn.mla_heads_tp(w, cfg, h, positions, mesh)
        if mode == "train":
            return y, None
        return y, (kv if mode == "decode" else
                   attn._latent_cache(*kv, max_len))

    def _rec_tp(self, p: Params, h, state):
        """The RG-LRU block channel-parallel over "model"
        (`recurrent.rglru_block_apply(mesh=)`): (y, new state), or None
        where the specs do not split its channels (or the state)."""
        dims = {"w_x": 1, "w_gate": 1, "conv_w": 1, "w_r": 0, "w_i": 0,
                "w_out": 0}
        if not all(shard_rules.tp_sharded(p[k], d) for k, d in dims.items()) \
                or not self._feature_split(self.cfg.d_model):
            return None
        w = self._tp_weights(p, dims)
        blk = shard_rules.model_block(self.mesh, self.cfg.d_model)
        for k in ("conv_b", "log_lambda"):        # per channel: the rank's
            w[k] = w[k][blk]
        return rec_lib.rglru_block_apply(w, self.cfg, h, state,
                                         mesh=self.mesh)

    def _moe(self, p: Params, h2: torch.Tensor, train: bool):
        """A MoE layer: (y, aux). On a mesh the routed experts run on this
        rank's block of their hidden dim where the specs split it so ("tp"
        expert sharding; "ep" expert weights are gathered whole at their
        use, as the reference's are), the shared experts column- and
        row-parallel; routing, capacity, drops and the aux loss are global
        (every dp rank routes the whole batch and keeps its own rows)."""
        mesh = self.mesh
        sh = shard_rules.tp_sharded
        routed = self._tp_on() and all(
            sh(p[k], d) for k, d in (("w_in", 2), ("w_gate", 2),
                                     ("w_out", 1)))
        shared = self._tp_on() and "shared_in" in p and all(
            sh(p[k], d) for k, d in (("shared_in", 1), ("shared_gate", 1),
                                     ("shared_out", 0)))
        dims = ({"w_in": 2, "w_gate": 2, "w_out": 1} if routed else {})
        if shared:
            dims.update(shared_in=1, shared_gate=1, shared_out=0)
        one = self._train_cast if train else self._cast
        w = {k: self._tp_cast(v, k, dims[k]) if k in dims else one(v, k)
             for k, v in p.items()}
        meshes = (mesh if routed else None, mesh if shared else None)
        if mesh is None or shard_rules.dp_size(mesh) == 1:
            return moe_lib.moe_apply(w, self.cfg, h2, *meshes)
        # gather point: the scatter dispatch routes over the whole batch,
        # and the outputs are combined for this rank's rows only
        r0 = shard_rules.dp_index(mesh) * h2.shape[0]
        return moe_lib.moe_apply(w, self.cfg,
                                 shard_rules.gather_batch(h2, mesh), *meshes,
                                 rows=slice(r0, r0 + h2.shape[0]))

    # -- stack execution ------------------------------------------------------

    def _apply_mlp(self, p: Params, h: torch.Tensor, mode: str) -> torch.Tensor:
        cfg = self.cfg
        if not cfg.cim_mlp_bits:
            return mlp(p, h, cfg.gating)
        if cfg.cim_host_twin:
            return _mlp_quantized(p, h, cfg.gating, cfg.cim_mlp_bits)
        return mlp_cim(p, h, cfg.gating, n_bits=cfg.cim_mlp_bits,
                       resident=cfg.cim_resident and mode == "decode",
                       resident_spec=self.resident_spec)

    def _layer_ffn(self, i: int, raw: Params, h2: torch.Tensor, mode: str):
        """Layer i's MLP: (y, aux), aux the MoE load-balancing loss (None
        for a dense MLP), tensor-parallel where the mesh and specs allow
        it."""
        if is_moe_layer(self.cfg, i):
            return self._moe(raw["mlp"], h2, mode == "train")
        if self._tp_on():
            y = self._mlp_tp(raw["mlp"], h2)
            if y is not None:
                return y, None
        return self._apply_mlp(self._cast_part(raw, "mlp", mode == "train"),
                               h2, mode), None

    def _cache_width(self, name: str) -> int:
        """A mixer cache leaf's last-dim width, by which it splits."""
        cfg = self.cfg
        return {"k": cfg.head_dim, "v": cfg.head_dim, "h": cfg.d_model,
                "conv": cfg.d_model,
                "c_kv": cfg.mla.kv_lora_rank if cfg.mla else 0,
                "k_rope": cfg.mla.qk_rope_dim if cfg.mla else 0}[name]

    def _mixer(self, kind: str, raw: Params, h, positions, mode: str,
               cache=None, max_len=None):
        """A layer's attention or recurrent block: (y, new cache; None in
        train), tensor-parallel where the mesh and specs allow it. A layer
        run whole on a mesh joins its cache's "model" blocks first and
        keeps its own block of the new cache."""
        cfg, train = self.cfg, mode == "train"
        out = None
        if self._tp_on():
            if kind == "rec":
                out = self._rec_tp(raw["rec"], h, cache)
            elif cfg.mla is not None and kind != "local":
                out = self._mla_tp(raw["attn"], h, positions, mode, cache,
                                   max_len)
            else:
                out = self._attn_tp(raw["attn"], h, positions, kind, mode,
                                    cache, max_len)
        if out is not None:
            return out[0], (None if train else out[1])
        mesh = self.mesh
        split = {} if cache is None or not self._tp_on() else {
            k: self._feature_split(self._cache_width(k)) for k in cache}
        if any(split.values()):
            cache = shard_rules.tree_join_blocks(cache, mesh, split)
        name = "rec" if kind == "rec" else "attn"
        p = self._cast_part(raw, name, train)
        if kind == "rec":       # prefill and train start from a zero state
            y, nc = rec_lib.rglru_block_apply(p, cfg, h, cache)
        elif cfg.mla is not None and kind != "local":
            if train:
                y, nc = attn.mla_apply(p, cfg, h, positions), None
            elif mode == "prefill":
                y, nc = attn.mla_prefill(p, cfg, h, positions, max_len)
            else:
                y, nc = attn.mla_decode(p, cfg, h, cache, positions)
        elif kind == "local":
            y, nc = ((attn.local_apply(p, cfg, h, positions), None) if train
                     else attn.local_prefill(p, cfg, h, positions)
                     if mode == "prefill" else
                     attn.local_decode(p, cfg, h, cache, positions))
        elif train:
            y, nc = attn.gqa_apply(p, cfg, h, positions, use_flash=True), None
        elif mode == "prefill":
            y, nc = attn.gqa_prefill(p, cfg, h, positions, max_len)
        elif cfg.cim_attention_bits:
            y, nc = attn.gqa_decode_cim(p, cfg, h, cache, positions)
        else:
            y, nc = attn.gqa_decode(p, cfg, h, cache, positions)
        if train:
            return y, None
        if self._tp_on():
            nc = {k: t[..., shard_rules.model_block(
                      mesh, self._cache_width(k))]
                  if self._feature_split(self._cache_width(k)) else t
                  for k, t in nc.items()}
        return y, nc

    def _train_layer(self, i: int, x, positions):
        """One layer of the train path, each kind from a zero state as the
        reference's train mode: ln1, the mixer (global attention through
        flash, or MLA; sliding-window attention; the RG-LRU block), ln2,
        MLP or MoE, both residuals; or an xLSTM cell after ln1. Returns
        (x, aux)."""
        if self.mesh is not None:
            # between layers x is a DTensor (batch x sequence under the
            # activation hint); a layer runs on this rank's rows
            y, aux = self._train_layer_local(
                i, shard_rules.local_batch(x), positions)
            return shard_rules.from_local_batch(y, self.mesh), aux
        return self._train_layer_local(i, x, positions)

    def _train_layer_local(self, i: int, x, positions):
        cfg = self.cfg
        kind = self.kinds[i]
        raw = self.layers[i].tree()

        def part(name):
            return self._cast_part(raw, name, train=True)
        h = rmsnorm(part("ln1"), x, cfg.norm_eps)
        if kind in XLSTM_CELLS:
            y, _ = XLSTM_CELLS[kind][1](part("cell"), cfg, h, None)
            return x + y, self._zero()
        x = x + self._mixer(kind, raw, h, positions, "train")[0]
        h2 = rmsnorm(part("ln2"), x, cfg.norm_eps)
        y, aux = self._layer_ffn(i, raw, h2, "train")
        return x + y, (self._zero() if aux is None else aux)

    def _zero(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=self.device)

    def _train_stack(self, x, positions):
        """The train path over the stack: (x after the final norm, the MoE
        layers' summed aux loss)."""
        cfg = self.cfg
        aux_total = self._zero()
        if self.mesh is not None:
            x = shard_rules.from_local_batch(x, self.mesh)
        with shard_rules.use_mesh(self.mesh):
            for i in range(len(self.kinds)):
                # 2-D (batch x seq) residency at each layer's input, as the
                # reference's period body
                x = hint_activation_sharding(x)
                if cfg.remat:
                    # the forward draws no random numbers, so the CUDA RNG
                    # state is not saved: a train step captured as a CUDA
                    # graph never reads the generator
                    x, aux = checkpoint(self._train_layer, i, x, positions,
                                        use_reentrant=False,
                                        preserve_rng_state=False)
                else:
                    x, aux = self._train_layer(i, x, positions)
                aux_total = aux_total + aux
        x = shard_rules.local_batch(x)
        return rmsnorm(self._whole(self.final_norm), x, cfg.norm_eps), \
            aux_total

    def _run_stack(self, x, positions, mode, caches=None, max_len=None):
        """Prefill or decode over the stack: (x after the final norm, the
        new caches). The MoE aux loss is dropped, as the reference's
        prefill and decode drop it. On a mesh a cache is this rank's rows
        and, where `cache_specs` splits the feature dim over "model", its
        block of it (a DTensor cache taken to its local block; the new
        caches are returned so); xLSTM states are taken whole."""
        cfg = self.cfg
        new_caches = []
        prefill = mode == "prefill"
        for i, (kind, layer) in enumerate(zip(self.kinds, self.layers)):
            raw = layer.tree()
            h = rmsnorm(self._cast_part(raw, "ln1"), x, cfg.norm_eps)
            cache = None if prefill else caches[i]
            if kind in XLSTM_CELLS:       # prefill starts from a zero state
                if self.mesh is not None:
                    cache = shard_rules.tree_local_batch(cache)
                y, nc = XLSTM_CELLS[kind][1](self._cast_part(raw, "cell"),
                                             cfg, h, cache)
                x = x + y
                new_caches.append(nc)
                continue
            if self.mesh is not None:
                cache = shard_rules.tree_local_shard(cache)
            y, nc = self._mixer(kind, raw, h, positions, mode, cache,
                                max_len)
            x = x + y
            h2 = rmsnorm(self._cast_part(raw, "ln2"), x, cfg.norm_eps)
            x = x + self._layer_ffn(i, raw, h2, mode)[0]
            new_caches.append(nc)
        x = rmsnorm(self._whole(self.final_norm), x, cfg.norm_eps)
        return x, new_caches

    def _embed_inputs(self, inputs) -> torch.Tensor:
        """Token embeddings, or an embed-stub config's precomputed
        `embeds` [B, T, D] (audio frames, image patches). On a mesh whose
        specs split the table's vocab over "model", each rank looks up the
        tokens of its block (`layers.embed(mesh=)`)."""
        act = self.cfg.activation_dtype()
        if self.cfg.embed_stub:
            return shard_rules.local_batch(inputs["embeds"]).to(act)
        tokens = shard_rules.local_batch(inputs["tokens"])
        table = self.embed["table"]
        if self._tp_on() and shard_rules.tp_sharded(table, 0):
            blk = shard_rules.gather_param_tp(table, 0)
            v0 = shard_rules.model_rank(self.mesh) * blk.shape[0]
            return embed({"table": blk}, tokens, self.mesh, v0).to(act)
        return embed(self._whole(self.embed), tokens).to(act)

    def _head(self):
        """(the head's weight [D, V], its first vocab column, the mesh):
        on a mesh whose specs split the vocab over "model", this rank's
        column block (the tied table's row block, transposed), else the
        whole weight and no mesh."""
        tied = self.cfg.tie_embeddings and not self.cfg.embed_stub
        t, dim = (self.embed["table"], 0) if tied else (self.lm_head["w"], 1)
        if self._tp_on() and shard_rules.tp_sharded(t, dim):
            w = shard_rules.gather_param_tp(t, dim)
            w = w.t() if tied else w
            return w, shard_rules.model_rank(self.mesh) * w.shape[1], \
                self.mesh
        w = shard_rules.gather_param(t)
        return (w.t() if tied else w), 0, None

    def logits(self, x_final: torch.Tensor) -> torch.Tensor:
        """Full logits over the padded vocab, pad columns masked (on a
        vocab-split mesh each rank's columns, joined by one all-gather)."""
        cfg = self.cfg
        w, v0, mesh = self._head()
        if mesh is not None:
            x_final = shard_rules.tp_enter(x_final, mesh)
        out = torch.matmul(x_final.float(), w.float())
        if cfg.vocab_padded != cfg.vocab_size:
            pad = torch.arange(v0, v0 + w.shape[1], device=out.device) \
                >= cfg.vocab_size
            out = out + pad * (-1e30)
        return out if mesh is None else shard_rules.tp_gather(out, mesh, -1)

    def _positions(self, x: torch.Tensor) -> torch.Tensor:
        b, t = x.shape[0], x.shape[1]
        return torch.arange(t, dtype=torch.int32,
                            device=x.device)[None].expand(b, t)

    def forward(self, inputs):
        """Full-sequence forward (train path): (logits_f32 [B, S, V],
        aux)."""
        x = self._embed_inputs(inputs)
        x, aux = self._train_stack(x, self._positions(x))
        return self.logits(x), aux

    def loss(self, batch):
        """Chunked-CE loss (never materializes the [B, S, V] logits):
        (loss, {"ce", "aux"}), loss = ce + 0.01 aux; aux, the MoE layers'
        summed load-balancing loss, is 0 without MoE. On a mesh, ce is the
        mean over this rank's rows (`train.step` averages the dp ranks),
        vocab-parallel where the head is split over "model"."""
        x = self._embed_inputs(batch)
        x, aux = self._train_stack(x, self._positions(x))
        w, v0, mesh = self._head()
        ce = chunked_lm_loss(x, w, shard_rules.local_batch(batch["targets"]),
                             real_vocab=self.cfg.vocab_size, mesh=mesh,
                             v0=v0)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    @torch.no_grad()
    def prefill(self, inputs, max_len: int):
        """Returns (caches, last_token_logits [B, V])."""
        x = self._embed_inputs(inputs)
        x, caches = self._run_stack(x, self._positions(x), "prefill",
                                    max_len=max_len)
        return caches, self.logits(x[:, -1:])[:, 0]

    @torch.no_grad()
    def decode_step(self, caches, inputs):
        """One token step. inputs: tokens [B,1] (or embeds [B,1,D]) +
        positions [B]."""
        x = self._embed_inputs(inputs)
        x, new_caches = self._run_stack(
            x, shard_rules.local_batch(inputs["positions"]), "decode",
            caches=caches)
        return new_caches, self.logits(x)[:, 0]


def build(cfg: ArchConfig, params: Optional[Params] = None, device=None,
          seed: int = 0, for_serving: bool = False) -> Model:
    """`Model(cfg, ...)`: random weights on `cuda` unless `device="cpu"`;
    `for_serving` holds the cast layer weights in the compute dtype only."""
    return Model(cfg, params=params, device=device, seed=seed,
                 for_serving=for_serving)


def with_cim(cfg: ArchConfig, bits: int) -> ArchConfig:
    """The serve engine's --cim-lower config: int8 MLP and decode attention."""
    return dataclasses.replace(cfg, cim_mlp_bits=bits, cim_attention_bits=bits,
                               cim_unroll_groups=True)
