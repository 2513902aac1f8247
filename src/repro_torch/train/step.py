"""Train, eval and serve step factories.

Port of `repro.train.step`. The train state is a plain dict {"params",
"opt", "step"} (plus "residuals" with gradient compression), whose
"params" are the model's own `nn.Parameter`s: a step runs the backward
into their `.grad`, then `adamw.update` writes the new values into them
in place. The ADRA tournament sampler waits (ROADMAP A4).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.optim import compression as gcomp
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
    one part at a time. Returns the (averaged) loss, ce and aux."""
    n = max(n_micro, 1)
    rows = batch["tokens"].shape[0]
    if rows % n:
        raise ValueError(f"batch of {rows} rows does not split into {n} "
                         f"microbatches")
    part = rows // n
    sums = {k: torch.zeros((), dtype=torch.float32, device=model.device)
            for k in ("loss", "ce", "aux")}
    for i in range(n):
        mb = {k: v[i * part:(i + 1) * part] for k, v in batch.items()}
        loss, parts = model.loss(mb)
        (loss / n if n > 1 else loss).backward()
        for k, val in (("loss", loss), *parts.items()):
            sums[k] = sums[k] + (val.detach() / n if n > 1 else val.detach())
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
        metrics = {**sums, "grad_norm": om["grad_norm"],
                   "lr": torch.as_tensor(lr, dtype=torch.float32)}
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
