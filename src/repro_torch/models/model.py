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
rows. The projections the specs shard on "model" run tensor-parallel,
Megatron's way (`_mlp_tp`, `_attn_tp`): a dense MLP (w_in/w_gate by
column, w_out by row) in every step, and global or sliding-window GQA
attention in the train step (wq and wo by head, each rank attending over
its block of heads, the flash kernel included); each rank gathers its
"model" block of those weights over the dp axes only and one all-reduce
over "model" sums the partial outputs. Every other parameter is gathered
whole at its use (`_cast`, `_train_cast`, `_whole`: an all-gather, whose
backward reduce-scatters the dp ranks' partial gradients) and its layer
runs whole on each "model" rank: MLA, MoE experts, the RG-LRU and xLSTM
blocks, the embedding and head, the CiM MLPs, and attention in prefill
and decode (the caches' specs shard head_dim, not heads). The activation
between train layers is a DTensor under the reference's hint (batch on
the dp axes, sequence on "model", gathered again at each layer's input),
a MoE layer gathers its batch over the dp axes and keeps its own rows of
the output (routing is global, as the reference's), and caches and
batches are taken to this rank's rows. Everything in a layer (the
kernels' autograd Functions included) runs on plain local tensors.

The prefill runs eagerly, so its CiM MLPs charge the ledger on every call
(the reference's jitted prefill charges once at trace time), and it never
pins weights (residency is off under the reference's jit tracers too).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

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

    def _tp_cast(self, t: torch.Tensor, name: str, dim: int) -> torch.Tensor:
        """This rank's "model" block of weight `name` (its dim `dim`),
        gathered over the dp axes and cast for compute."""
        t = shard_rules.gather_param_tp(t, dim)
        act = self.cfg.activation_dtype()
        return t.to(act) if _cast_rule(name, t, act) else t

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

    def _attn_tp(self, p: Params, h: torch.Tensor, positions,
                 kind: str) -> Optional[torch.Tensor]:
        """Train-path GQA attention (global or sliding-window) run
        tensor-parallel over "model": this rank's block of query heads
        (wq by head), the key/value heads they read (wk/wv by head where
        the specs shard them so, else gathered whole and sliced), and the
        row-parallel wo with one all-reduce of the float32 output. None
        where the specs do not shard wq and wo by head, or a rank's query
        heads would straddle key/value groups: the caller then gathers the
        layer whole."""
        cfg = self.cfg
        if not (shard_rules.tp_sharded(p["wq"], 1)
                and shard_rules.tp_sharded(p["wo"], 0)):
            return None
        mesh = self.mesh
        hq = cfg.n_heads // shard_rules.model_parallel(mesh)
        group = cfg.n_heads // cfg.n_kv_heads
        kv_tp = shard_rules.tp_sharded(p["wk"], 1) and \
            shard_rules.tp_sharded(p["wv"], 1)
        if not kv_tp and hq % group and group % hq:
            return None
        w = {"wq": self._tp_cast(p["wq"], "wq", 1),
             "wo": self._tp_cast(p["wo"], "wo", 0)}
        if kv_tp:
            w["wk"] = self._tp_cast(p["wk"], "wk", 1)
            w["wv"] = self._tp_cast(p["wv"], "wv", 1)
        else:
            rank = mesh.get_local_rank("model")
            k0 = rank * hq // group
            k1 = max(k0 + 1, (rank + 1) * hq // group)
            for k in ("wk", "wv"):
                w[k] = self._train_cast(shard_rules.gather_param(
                    p[k], partial_model=True), k)[:, k0:k1]
        for k in ("q_norm", "k_norm"):    # each rank normalises its heads
            if k in p:
                w[k] = {n: shard_rules.gather_param(v, partial_model=True)
                        for n, v in p[k].items()}
        x = shard_rules.tp_enter(h, mesh)

        def reduce(y):
            return shard_rules.tp_exit(y, mesh)
        if kind == "local":
            return attn.local_apply(w, cfg, x, positions, reduce=reduce)
        return attn.gqa_apply(w, cfg, x, positions, use_flash=True,
                              reduce=reduce)

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

    def _ffn(self, i: int, p: Params, h2: torch.Tensor, mode: str):
        """Layer i's MLP: (y, aux), aux the MoE load-balancing loss (None
        for a dense MLP)."""
        if is_moe_layer(self.cfg, i):
            mesh = self.mesh
            if mesh is None or shard_rules.dp_size(mesh) == 1:
                return moe_lib.moe_apply(p, self.cfg, h2)
            # gather point: the scatter dispatch routes over the whole
            # batch (capacity, drops and the aux loss are global, as the
            # reference's), so every dp rank runs it on all rows and keeps
            # its own
            y, aux = moe_lib.moe_apply(p, self.cfg,
                                       shard_rules.gather_batch(h2, mesh))
            return shard_rules.local_rows(y, mesh), aux
        return self._apply_mlp(p, h2, mode), None

    def _train_layer(self, i: int, x, positions):
        """One layer of the train path, each kind from a zero state as the
        reference's train mode: ln1, the mixer (global attention through
        flash, or MLA; sliding-window attention; the RG-LRU block), ln2,
        MLP or MoE, both residuals; or an xLSTM cell after ln1. Returns
        (x, aux)."""
        if self.mesh is not None:
            # between layers x is a DTensor (batch x sequence under the
            # activation hint); a layer runs on this rank's rows, whole
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
        y = None
        if kind == "rec":
            y, _ = rec_lib.rglru_block_apply(part("rec"), cfg, h, None)
        elif cfg.mla is not None and kind != "local":
            y = attn.mla_apply(part("attn"), cfg, h, positions)
        elif self.mesh is not None:
            y = self._attn_tp(raw["attn"], h, positions, kind)
        if y is None and kind == "local":
            y = attn.local_apply(part("attn"), cfg, h, positions)
        elif y is None:
            y = attn.gqa_apply(part("attn"), cfg, h, positions, use_flash=True)
        x = x + y
        h2 = rmsnorm(part("ln2"), x, cfg.norm_eps)
        y, aux = self._layer_ffn(i, raw, h2, "train")
        return x + y, (self._zero() if aux is None else aux)

    def _layer_ffn(self, i: int, raw: Params, h2: torch.Tensor, mode: str):
        """`_ffn` of layer i from its raw parameters: a dense MLP
        tensor-parallel where the mesh and specs allow it."""
        if self.mesh is not None and not is_moe_layer(self.cfg, i):
            y = self._mlp_tp(raw["mlp"], h2)
            if y is not None:
                return y, None
        return self._ffn(i, self._cast_part(raw, "mlp", mode == "train"),
                         h2, mode)

    def _zero(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=self.device)

    def _attend(self, p: Params, h, positions, mode, cache, max_len):
        """Global attention of one `attn` layer in prefill or decode."""
        cfg = self.cfg
        if cfg.mla is not None:
            if mode == "prefill":
                return attn.mla_prefill(p, cfg, h, positions, max_len)
            return attn.mla_decode(p, cfg, h, cache, positions)
        if mode == "prefill":
            return attn.gqa_prefill(p, cfg, h, positions, max_len)
        if cfg.cim_attention_bits:
            return attn.gqa_decode_cim(p, cfg, h, cache, positions)
        return attn.gqa_decode(p, cfg, h, cache, positions)

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
                    x, aux = checkpoint(self._train_layer, i, x, positions,
                                        use_reentrant=False)
                else:
                    x, aux = self._train_layer(i, x, positions)
                aux_total = aux_total + aux
        x = shard_rules.local_batch(x)
        return rmsnorm(self._whole(self.final_norm), x, cfg.norm_eps), \
            aux_total

    def _run_stack(self, x, positions, mode, caches=None, max_len=None):
        """Prefill or decode over the stack: (x after the final norm, the
        new caches). The MoE aux loss is dropped, as the reference's
        prefill and decode drop it."""
        cfg = self.cfg
        new_caches = []
        prefill = mode == "prefill"
        for i, (kind, layer) in enumerate(zip(self.kinds, self.layers)):
            raw = layer.tree()
            p = {k: self._cast_part(raw, k) for k in raw if k != "mlp"}
            h = rmsnorm(p["ln1"], x, cfg.norm_eps)
            cache = None if prefill else caches[i]
            if self.mesh is not None:
                cache = shard_rules.tree_local_batch(cache)
            if kind in XLSTM_CELLS:       # prefill starts from a zero state
                y, nc = XLSTM_CELLS[kind][1](p["cell"], cfg, h, cache)
                x = x + y
                new_caches.append(nc)
                continue
            if kind == "rec":             # prefill starts from a zero state
                y, nc = rec_lib.rglru_block_apply(p["rec"], cfg, h, cache)
            elif kind == "local":
                y, nc = (attn.local_prefill(p["attn"], cfg, h, positions)
                         if prefill else
                         attn.local_decode(p["attn"], cfg, h, cache,
                                           positions))
            else:
                y, nc = self._attend(p["attn"], h, positions, mode, cache,
                                     max_len)
            x = x + y
            h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
            x = x + self._layer_ffn(i, raw, h2, mode)[0]
            new_caches.append(nc)
        x = rmsnorm(self._whole(self.final_norm), x, cfg.norm_eps)
        return x, new_caches

    def _embed_inputs(self, inputs) -> torch.Tensor:
        """Token embeddings, or an embed-stub config's precomputed
        `embeds` [B, T, D] (audio frames, image patches)."""
        act = self.cfg.activation_dtype()
        if self.cfg.embed_stub:
            return shard_rules.local_batch(inputs["embeds"]).to(act)
        return embed(self._whole(self.embed),
                     shard_rules.local_batch(inputs["tokens"])).to(act)

    def _head_weight(self) -> torch.Tensor:
        if self.cfg.tie_embeddings and not self.cfg.embed_stub:
            return shard_rules.gather_param(self.embed["table"]).t()
        return shard_rules.gather_param(self.lm_head["w"])

    def logits(self, x_final: torch.Tensor) -> torch.Tensor:
        """Full logits over the padded vocab, pad columns masked."""
        cfg = self.cfg
        out = torch.matmul(x_final.float(), self._head_weight().float())
        if cfg.vocab_padded != cfg.vocab_size:
            pad = torch.arange(cfg.vocab_padded, device=out.device) \
                >= cfg.vocab_size
            out = out + pad * (-1e30)
        return out

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
        mean over this rank's rows (`train.step` averages the dp ranks)."""
        x = self._embed_inputs(batch)
        x, aux = self._train_stack(x, self._positions(x))
        ce = chunked_lm_loss(x, self._head_weight(),
                             shard_rules.local_batch(batch["targets"]),
                             real_vocab=self.cfg.vocab_size)
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
