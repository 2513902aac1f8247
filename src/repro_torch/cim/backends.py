"""CiM backend registry: one dispatch point for every ADRA execution model.

Port of `repro.cim.backends`. A backend is a callable over packed planes:

    fn(a_planes int32[n, W], b_planes int32[n, W], ops: tuple[str, ...])
        -> tuple[torch.Tensor, ...]   # one output per op, opset shape rules

Registered backends:

  fused          — the fused bit-plane kernel's wrapper
                   (`fused_kernel.fused_planes_op`): the CUDA kernel for
                   CUDA tensors, its plain version for CPU tensors
  torch-boolean  — the plain PyTorch plane math on any device (the port of
                   `_jnp_boolean_backend`, ideal SAs)

The analog-oracle backend waits for the port of `repro.core.adra`.
Resolution order: explicit argument > REPRO_TORCH_CIM_BACKEND env var >
"fused". The env var is the port's own, so the
reference's REPRO_CIM_BACKEND never hands it a name it lacks.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

import torch

from .fused_kernel import fused_planes_op, fused_planes_op_ref

BackendFn = Callable[[torch.Tensor, torch.Tensor, Tuple[str, ...]],
                     Tuple[torch.Tensor, ...]]

ENV_VAR = "REPRO_TORCH_CIM_BACKEND"


@dataclasses.dataclass(frozen=True)
class Backend:
    name: str
    fn: BackendFn
    description: str

    def __call__(self, a_planes, b_planes, ops):
        return self.fn(a_planes, b_planes, ops)


_REGISTRY: Dict[str, Backend] = {}


def register_backend(name: str, fn: BackendFn, description: str = "") -> Backend:
    bk = Backend(name=name, fn=fn, description=description)
    _REGISTRY[name] = bk
    return bk


def available_backends() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def default_backend_name() -> str:
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    return "fused"


def get_backend(name: Optional[str] = None) -> Backend:
    name = name or default_backend_name()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown CiM backend {name!r}; have {available_backends()}") from None


register_backend(
    "fused", lambda a, b, ops: fused_planes_op(a.contiguous(), b.contiguous(),
                                               tuple(ops)),
    "fused single-pass kernel (CUDA), plain version for CPU tensors")
register_backend(
    "torch-boolean", lambda a, b, ops: fused_planes_op_ref(a, b, tuple(ops)),
    "plain PyTorch plane math with ideal SAs")
