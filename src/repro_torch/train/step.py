"""Train, eval and serve step factories.

Port of `repro.train.step`. The train state is a plain dict {"params",
"opt", "step"} (plus "residuals" with gradient compression), whose
"params" are the model's own `nn.Parameter`s: a step runs the backward
into their `.grad`, then `adamw.update` writes the new values into them
in place. `adra_sample` is the serve path's quantized argmax through the
ADRA comparison: a tournament whose every level is one lowered access on
the fused bit-plane kernel; `adra_sample_ref` is its plain version.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.optim import compression as gcomp
from repro_torch.sharding import rules as shard_rules
from repro_torch.tree import leaves, tree_map

TrainState = Dict[str, Any]


def init_state(model: Model, opt_cfg: adamw.AdamWConfig,
               compress_grads: bool = False) -> TrainState:
    """The train state over the model's parameters (their gradients are
    switched on), zero moments and step 0."""
    params = model.params()
    for p in leaves(params):
        p.requires_grad_(True)
    state: TrainState = {
        "params": params,
        "opt": adamw.init(params, opt_cfg),
        "step": torch.zeros((), dtype=torch.int32, device=model.device),
    }
    if compress_grads:
        state["residuals"] = gcomp.init_residuals(params)
    return state


def accumulate_grads(model: Model, batch: Dict[str, torch.Tensor],
                     n_micro: int) -> Dict[str, torch.Tensor]:
    """The backward of one batch into the parameters' `.grad` (which the
    caller has cleared): with n_micro > 1 the batch is split along dim 0
    into n parts and `(loss_i / n).backward()` runs on each, so the summed
    `.grad` is the reference's averaged grads and activations are held for
    one part at a time. Returns the (averaged) loss, ce and aux, each the
    mean over the parts as the reference's accumulation scan takes it (aux
    is the MoE layers' load-balancing loss; 0 without MoE). On a mesh
    (`model.mesh`) each rank runs its own rows of a DTensor batch and the
    returned values are the mean over the dp ranks."""
    n = max(n_micro, 1)
    mesh = model.mesh
    n_dp = 1
    if mesh is not None:
        # this rank's rows; each rank's loss counts 1/n_dp of the global
        # mean, so the reduce-scattered gradients are the global ones
        n_dp = shard_rules.dp_size(mesh)
        if batch["targets"].shape[0] % n_dp:
            raise ValueError(f"batch of {batch['targets'].shape[0]} rows "
                             f"does not split over {n_dp} dp ranks")
        batch = {k: shard_rules.local_batch(v) for k, v in batch.items()}
    rows = batch["targets"].shape[0]
    if rows % n:
        raise ValueError(f"batch of {rows} rows does not split into {n} "
                         f"microbatches")
    part = rows // n
    sums = {k: torch.zeros((), dtype=torch.float32, device=model.device)
            for k in ("loss", "ce", "aux")}
    for i in range(n):
        mb = {k: v[i * part:(i + 1) * part] for k, v in batch.items()}
        loss, parts = model.loss(mb)
        (loss / (n * n_dp) if n * n_dp > 1 else loss).backward()
        for k, val in (("loss", loss), *parts.items()):
            sums[k] = sums[k] + (val.detach() / n if n > 1 else val.detach())
    if mesh is not None:
        sums = {k: shard_rules.dp_mean(v, mesh) for k, v in sums.items()}
    return sums


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    lr_schedule: Optional[Callable] = None,
                    compress_grads: bool = False,
                    microbatches: Optional[int] = None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics): the gradients
    of the batch (`accumulate_grads`, `microbatches` parts, by default the
    config's), optionally int8-compressed with error feedback, then one
    AdamW update in place. metrics: loss, ce, aux, grad_norm, lr."""
    n_micro = microbatches if microbatches is not None \
        else model.cfg.microbatches

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state["params"]
        tensors = leaves(params)
        for p in tensors:
            p.grad = None
        sums = accumulate_grads(model, batch, n_micro)
        grads = tree_map(
            lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
            params)
        new_state: TrainState = dict(state)
        if compress_grads:
            grads, new_state["residuals"] = gcomp.compress_tree(
                grads, state["residuals"])
        lr = lr_schedule(state["step"]) if lr_schedule else opt_cfg.lr
        _, new_state["opt"], om = adamw.update(grads, state["opt"], params,
                                               opt_cfg, lr)
        for p in tensors:
            p.grad = None
        del grads
        new_state["step"] = state["step"] + 1
        metrics = {**sums, "grad_norm": shard_rules.to_plain(om["grad_norm"]),
                   "lr": (lr.to(torch.float32) if torch.is_tensor(lr)
                          else torch.full((), lr, dtype=torch.float32,
                                          device=model.device))}
        return new_state, metrics

    return train_step


def make_eval_step(model: Model) -> Callable:
    @torch.no_grad()
    def eval_step(batch):
        loss, parts = model.loss(batch)
        return {"loss": loss, **parts}
    return eval_step


def make_prefill_step(model: Model, max_len: int) -> Callable:
    def prefill(inputs):
        return model.prefill(inputs, max_len)
    return prefill


def make_decode_step(model: Model) -> Callable:
    def decode(caches, inputs):
        return model.decode_step(caches, inputs)
    return decode


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the vocab (first index on ties, as jnp.argmax)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _adra_level(a: torch.Tensor, b: torch.Tensor, ia: torch.Tensor,
                ib: torch.Tensor):
    """One tournament level: strict a < b picks the right entrant (ties keep
    the earlier index, argmax semantics). Captured by the lowering compiler
    as one region: the comparison is a single-access `lt` and both selects
    are zero-access writebacks, so a level is a one-access schedule."""
    take_b = a < b
    return torch.where(take_b, b, a), torch.where(take_b, ib, ia)


_ADRA_LEVEL_LOWERED = None


def _adra_quantize(logits: torch.Tensor, n_bits: int) -> torch.Tensor:
    """The reference's quantization of logits to n_bits for the compare:
    masked (below -1e29) padded-vocab columns are clamped to the finite
    floor so they keep the scale, then (x - lo) / ((hi - lo) / (2^n - 2))
    rounded half to even, as int16 (n_bits <= 15) or int32."""
    x = logits.to(torch.float32)
    finite_lo = torch.where(x < -1e29, torch.full_like(x, float("inf")),
                            x).amin(-1, keepdim=True)
    x = torch.maximum(x, finite_lo)
    hi = x.amax(-1, keepdim=True)
    scale = (hi - finite_lo) / (2 ** n_bits - 2)
    q = torch.round((x - finite_lo) / torch.clamp_min(scale, 1e-9))
    return q.to(torch.int16 if n_bits + 1 <= 16 else torch.int32)


def adra_sample(logits: torch.Tensor, n_bits: int = 8) -> torch.Tensor:
    """Quantized argmax through the ADRA comparison primitive: logits
    [..., V] are quantized to n_bits and the winner found by a tournament
    of single-access in-memory comparisons, ceil(log2 V) levels, each one
    dispatch of the level lowered once through `repro_torch.cim.lower`
    (on the fused kernel for CUDA tensors). An odd level repeats its last
    entrant. Returns int32 [...] indices (earliest on ties)."""
    global _ADRA_LEVEL_LOWERED
    if _ADRA_LEVEL_LOWERED is None:
        from repro_torch.cim.lower import lower

        _ADRA_LEVEL_LOWERED = lower(_adra_level)
    level = _ADRA_LEVEL_LOWERED

    vals = _adra_quantize(logits, n_bits)
    idxs = torch.arange(vals.shape[-1], dtype=torch.int32,
                        device=vals.device).expand(vals.shape)
    while vals.shape[-1] > 1:
        if vals.shape[-1] % 2:
            vals = torch.cat([vals, vals[..., -1:]], -1)
            idxs = torch.cat([idxs, idxs[..., -1:]], -1)
        vals, idxs = level(vals[..., 0::2].contiguous(),
                           vals[..., 1::2].contiguous(),
                           idxs[..., 0::2].contiguous(),
                           idxs[..., 1::2].contiguous())
    return idxs[..., 0]


def adra_sample_ref(logits: torch.Tensor, n_bits: int = 8) -> torch.Tensor:
    """The plain version of `adra_sample`: the same quantization, then
    argmax (earliest index on ties). For tests and the card's check; the
    serve path never calls it."""
    return torch.argmax(_adra_quantize(logits, n_bits).to(torch.int32),
                        dim=-1).to(torch.int32)
