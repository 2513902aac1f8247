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
from . import attention as attn
from . import moe as moe_lib
from . import recurrent as rec_lib
from . import xlstm as xlstm_lib
from .layers import (
    chunked_lm_loss,
    embed,
    embed_init,
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
    (`cuda` unless the caller passes `device="cpu"`; raises without a GPU).
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
            gen = torch.Generator(device=device).manual_seed(seed)
            params = init_params(cfg, gen, device, for_serving)
        if "embed" in params:
            self.embed = _pdict(params["embed"])
        self.layers = nn.ModuleList(Layer(p) for p in params["layers"])
        self.final_norm = _pdict(params["final_norm"])
        if "lm_head" in params:
            self.lm_head = _pdict(params["lm_head"])
        # id(param) -> (param, compute-dtype copy); shared with derived models
        self._cast_cache = {} if _cast_cache is None else _cast_cache

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
        so the same tensor comes back each call."""
        if not _cast_rule(name, t, self.cfg.activation_dtype()):
            return t
        hit = self._cast_cache.get(id(t))
        if hit is None or hit[0] is not t:
            hit = self._cast_cache[id(t)] = (
                t, t.detach().to(self.cfg.activation_dtype()))
        return hit[1]

    def _train_cast(self, t: torch.Tensor, name: str = "") -> torch.Tensor:
        """`_compute_cast` for the train path: a fresh cast on every call,
        so gradients reach the float32 master weights."""
        act = self.cfg.activation_dtype()
        return t.to(act) if _cast_rule(name, t, act) else t

    def _layer_params(self, layer: Layer, train: bool = False) -> Params:
        one = self._train_cast if train else self._cast

        def cast(tree):
            return {k: cast(v) if isinstance(v, dict) else one(v, k)
                    for k, v in tree.items()}
        return cast(layer.tree())

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
            return moe_lib.moe_apply(p, self.cfg, h2)
        return self._apply_mlp(p, h2, mode), None

    def _train_layer(self, i: int, x, positions):
        """One layer of the train path, each kind from a zero state as the
        reference's train mode: ln1, the mixer (global attention through
        flash, or MLA; sliding-window attention; the RG-LRU block), ln2,
        MLP or MoE, both residuals; or an xLSTM cell after ln1. Returns
        (x, aux)."""
        cfg = self.cfg
        kind = self.kinds[i]
        p = self._layer_params(self.layers[i], train=True)
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        if kind in XLSTM_CELLS:
            y, _ = XLSTM_CELLS[kind][1](p["cell"], cfg, h, None)
            return x + y, self._zero()
        if kind == "rec":
            y, _ = rec_lib.rglru_block_apply(p["rec"], cfg, h, None)
        elif kind == "local":
            y = attn.local_apply(p["attn"], cfg, h, positions)
        elif cfg.mla is not None:
            y = attn.mla_apply(p["attn"], cfg, h, positions)
        else:
            y = attn.gqa_apply(p["attn"], cfg, h, positions, use_flash=True)
        x = x + y
        h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
        y, aux = self._ffn(i, p["mlp"], h2, "train")
        return x + y, (self._zero() if aux is None else aux)

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
        for i in range(len(self.kinds)):
            if cfg.remat:
                x, aux = checkpoint(self._train_layer, i, x, positions,
                                    use_reentrant=False)
            else:
                x, aux = self._train_layer(i, x, positions)
            aux_total = aux_total + aux
        return rmsnorm(dict(self.final_norm.items()), x, cfg.norm_eps), \
            aux_total

    def _run_stack(self, x, positions, mode, caches=None, max_len=None):
        """Prefill or decode over the stack: (x after the final norm, the
        new caches). The MoE aux loss is dropped, as the reference's
        prefill and decode drop it."""
        cfg = self.cfg
        new_caches = []
        prefill = mode == "prefill"
        for i, (kind, layer) in enumerate(zip(self.kinds, self.layers)):
            p = self._layer_params(layer)
            h = rmsnorm(p["ln1"], x, cfg.norm_eps)
            cache = None if prefill else caches[i]
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
            x = x + self._ffn(i, p["mlp"], h2, mode)[0]
            new_caches.append(nc)
        x = rmsnorm(dict(self.final_norm.items()), x, cfg.norm_eps)
        return x, new_caches

    def _embed_inputs(self, inputs) -> torch.Tensor:
        """Token embeddings, or an embed-stub config's precomputed
        `embeds` [B, T, D] (audio frames, image patches)."""
        act = self.cfg.activation_dtype()
        if self.cfg.embed_stub:
            return inputs["embeds"].to(act)
        return embed(dict(self.embed.items()), inputs["tokens"]).to(act)

    def _head_weight(self) -> torch.Tensor:
        if self.cfg.tie_embeddings and not self.cfg.embed_stub:
            return self.embed["table"].t()
        return self.lm_head["w"]

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
        summed load-balancing loss, is 0 without MoE."""
        x = self._embed_inputs(batch)
        x, aux = self._train_stack(x, self._positions(x))
        ce = chunked_lm_loss(x, self._head_weight(), batch["targets"],
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
        x, new_caches = self._run_stack(x, inputs["positions"], "decode",
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
