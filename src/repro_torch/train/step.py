"""Serve step factories.

Port of the serving part of `repro.train.step`: the prefill and decode step
closures over a model and greedy sampling. The train step and the ADRA
tournament sampler wait.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.model import Model


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
