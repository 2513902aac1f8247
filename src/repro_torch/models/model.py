"""Model assembly for the dense, hybrid and xLSTM stacks: parameters,
caches, and the train, prefill and decode paths.

Port of `repro.models.model` for layer kinds `attn` (global GQA/MQA
attention), `local` (sliding-window attention with a ring-buffer cache) and
`rec` (the Griffin RG-LRU block), each followed by an MLP, and `mlstm` /
`slstm` (the xLSTM blocks: `x + cell(rmsnorm(x))`, no MLP). The reference
stacks its layers per pattern period and scans over them, unrolling the
scan for serving (`cim_unroll_groups`) and memoizing per-group parameter
slices so the same arrays reach every call (`Model._group_param_slices`).
The port is an `nn.Module` with one module per layer in the reference's
stack order (its `StackLayout`: the pattern repeated, then the remainder),
so every layer always receives the same parameter tensors; the
compute-dtype casts of prefill and decode (`_compute_cast`, bf16 at full
width) are memoized per parameter for the same reason — resident weight
pins are keyed by tensor identity and stay warm across calls.

The train path (`forward`, `loss`; mode "train" of `_run_stack`) runs
`attn` stacks. Its compute-dtype cast is a fresh, differentiable
`t.to(act)` on every call (the memoized casts are detached), and under
`cfg.remat` each layer runs under `torch.utils.checkpoint`, as the
reference checkpoints each pattern period (period 1 for gemma). One
departure: the reference's train forward calls `gqa_apply` without
`use_flash` (`src/repro/models/model.py:153`), so it attends through the
dense `_sdpa` or the jnp blockwise form, and its Pallas flash kernel
covers real-TPU execution; on the card the port plays the TPU's role, so
its train forward calls `gqa_apply(use_flash=True)`: the CUDA flash kernel
forward, the blockwise backward. Both compute the same function and are
held to each other. `rec`, `local`, `mlstm` and `slstm` layers do not
train yet (ROADMAP A11).

Differences from the reference: MoE and MLA wait. The prefill runs
eagerly, so its CiM MLPs charge the ledger on every call (the reference's
jitted prefill charges once at trace time), and it never pins weights
(residency is off under the reference's jit tracers too).
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

#: layer kinds whose train path waits, with the ROADMAP item that ports it
TRAIN_WAITS = {
    "rec": "ROADMAP A11: the hybrid train path (RG-LRU backward)",
    "local": "ROADMAP A11: the hybrid train path",
    "mlstm": "ROADMAP A11: the xLSTM train path",
    "slstm": "ROADMAP A11: the xLSTM train path (sLSTM backward)",
}

#: the layer kinds this port runs
LAYER_KINDS = ("attn", "local", "rec", "mlstm", "slstm")
#: the xLSTM kinds: one cell after ln1, no ln2 and no MLP
XLSTM_CELLS = {"mlstm": (xlstm_lib.mlstm_init, xlstm_lib.mlstm_apply,
                         xlstm_lib.mlstm_make_state),
               "slstm": (xlstm_lib.slstm_init, xlstm_lib.slstm_apply,
                         xlstm_lib.slstm_make_state)}


def _layer_init(gen, cfg: ArchConfig, kind: str, dtype, device) -> Params:
    p: Params = {"ln1": rmsnorm_init(cfg.d_model, dtype, device)}
    if kind in XLSTM_CELLS:
        p["cell"] = XLSTM_CELLS[kind][0](gen, cfg, dtype, device)
        return p
    if kind == "rec":
        p["rec"] = rec_lib.rglru_block_init(gen, cfg, dtype, device)
    else:
        p["attn"] = attn.gqa_init(gen, cfg, dtype, device)
    p["ln2"] = rmsnorm_init(cfg.d_model, dtype, device)
    p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gating, dtype, device)
    return p


def init_params(cfg: ArchConfig, gen: torch.Generator, device) -> Params:
    """Random parameters with the reference's init distributions, from an
    explicit generator: {"embed", "layers": [...], "final_norm"[, "lm_head"]}."""
    dtype = cfg.param_torch_dtype()
    kinds = cfg.pattern_layers()
    if cfg.moe is not None or cfg.mla is not None or \
            any(k not in LAYER_KINDS for k in kinds):
        raise NotImplementedError(
            f"{cfg.name}: only {LAYER_KINDS} stacks without MoE or MLA are "
            f"ported")
    params: Params = {}
    if not cfg.embed_stub:
        params["embed"] = embed_init(gen, cfg.vocab_padded, cfg.d_model,
                                     dtype, device)
    params["layers"] = [_layer_init(gen, cfg, kind, dtype, device)
                        for kind in kinds]
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
    `resident_spec` is the ArraySpec whose registry ResidentSet holds the
    decode weight pins (None: the paper's DEFAULT_SPEC)."""

    def __init__(self, cfg: ArchConfig, params: Optional[Params] = None,
                 device=None, seed: int = 0,
                 resident_spec: Optional[ArraySpec] = None,
                 _cast_cache: Optional[dict] = None):
        super().__init__()
        self.cfg = cfg
        self.kinds = cfg.pattern_layers()
        self.resident_spec = resident_spec
        if params is None:
            device = resolve_device(device)
            gen = torch.Generator(device=device).manual_seed(seed)
            params = init_params(cfg, gen, device)
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
            else:
                out.append(attn.gqa_make_cache(cfg, batch, max_len, dtype,
                                               dev))
        return out

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        """The reference's `_compute_cast`: f32 weights of rank >= 2 in the
        activation dtype, memoized so the same tensor comes back each call."""
        act = self.cfg.activation_dtype()
        if act == torch.float32 or t.dtype != torch.float32 or t.dim() < 2:
            return t
        hit = self._cast_cache.get(id(t))
        if hit is None or hit[0] is not t:
            hit = self._cast_cache[id(t)] = (t, t.detach().to(act))
        return hit[1]

    def _train_cast(self, t: torch.Tensor) -> torch.Tensor:
        """`_compute_cast` for the train path: a fresh cast on every call,
        so gradients reach the float32 master weights."""
        act = self.cfg.activation_dtype()
        if act == torch.float32 or t.dtype != torch.float32 or t.dim() < 2:
            return t
        return t.to(act)

    def _layer_params(self, layer: Layer, train: bool = False) -> Params:
        one = self._train_cast if train else self._cast

        def cast(tree):
            if isinstance(tree, dict):
                return {k: cast(v) for k, v in tree.items()}
            return one(tree)
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

    def _train_layer(self, i: int, x, positions) -> torch.Tensor:
        """One `attn` layer of the train path: ln1, flash attention, ln2,
        MLP, both residuals."""
        cfg = self.cfg
        p = self._layer_params(self.layers[i], train=True)
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        x = x + attn.gqa_apply(p["attn"], cfg, h, positions, use_flash=True)
        h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
        return x + self._apply_mlp(p["mlp"], h2, "train")

    def _run_stack(self, x, positions, mode, caches=None, max_len=None):
        cfg = self.cfg
        if mode == "train":
            for i, kind in enumerate(self.kinds):
                if kind != "attn":
                    raise NotImplementedError(
                        f"{cfg.name}: layer {i} ({kind!r}) has no train "
                        f"path yet; {TRAIN_WAITS[kind]}")
                if cfg.remat:
                    x = checkpoint(self._train_layer, i, x, positions,
                                   use_reentrant=False)
                else:
                    x = self._train_layer(i, x, positions)
            x = rmsnorm(dict(self.final_norm.items()), x, cfg.norm_eps)
            return x, []
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
            elif prefill:
                y, nc = attn.gqa_prefill(p["attn"], cfg, h, positions, max_len)
            elif cfg.cim_attention_bits:
                y, nc = attn.gqa_decode_cim(p["attn"], cfg, h, cache,
                                            positions)
            else:
                y, nc = attn.gqa_decode(p["attn"], cfg, h, cache, positions)
            x = x + y
            h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
            x = x + self._apply_mlp(p["mlp"], h2, mode)
            new_caches.append(nc)
        x = rmsnorm(dict(self.final_norm.items()), x, cfg.norm_eps)
        return x, new_caches

    def _embed_inputs(self, inputs) -> torch.Tensor:
        return embed(dict(self.embed.items()),
                     inputs["tokens"]).to(self.cfg.activation_dtype())

    def _head_weight(self) -> torch.Tensor:
        if self.cfg.tie_embeddings:
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
        x, _ = self._run_stack(x, self._positions(x), "train")
        return self.logits(x), torch.zeros((), dtype=torch.float32,
                                           device=x.device)

    def loss(self, batch):
        """Chunked-CE loss (never materializes the [B, S, V] logits):
        (loss, {"ce", "aux"}), loss = ce + 0.01 aux; aux is 0 without
        MoE."""
        x = self._embed_inputs(batch)
        x, _ = self._run_stack(x, self._positions(x), "train")
        ce = chunked_lm_loss(x, self._head_weight(), batch["targets"],
                             real_vocab=self.cfg.vocab_size)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
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
        """One token step. inputs: tokens [B,1] + positions [B]."""
        x = self._embed_inputs(inputs)
        x, new_caches = self._run_stack(x, inputs["positions"], "decode",
                                        caches=caches)
        return new_caches, self.logits(x)[:, 0]


def build(cfg: ArchConfig, params: Optional[Params] = None, device=None,
          seed: int = 0) -> Model:
    """`Model(cfg, ...)`: random weights on `cuda` unless `device="cpu"`."""
    return Model(cfg, params=params, device=device, seed=seed)


def with_cim(cfg: ArchConfig, bits: int) -> ArchConfig:
    """The serve engine's --cim-lower config: int8 MLP and decode attention."""
    return dataclasses.replace(cfg, cim_mlp_bits=bits, cim_attention_bits=bits,
                               cim_unroll_groups=True)
