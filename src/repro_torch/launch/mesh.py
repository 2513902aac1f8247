"""Production and smoke meshes.

Port of `repro.launch.mesh`: a mesh is a
`torch.distributed.device_mesh.DeviceMesh` with the reference's axis names,
("data", "model") or ("pod", "data", "model"), over the ranks of the
process group the caller initialised (`torchrun` and NCCL on cards, `gloo`
on CPUs, or the dry run's fake group of 256 or 512 ranks). Defined as
functions, never module-level constants, so importing this module creates
no process group and no mesh.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def default_device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(shape, axis_names, device_type: Optional[str] = None
              ) -> DeviceMesh:
    """A mesh of `shape` over the process group's ranks (its size must be
    the product of `shape`)."""
    return init_device_mesh(device_type or default_device_type(),
                            tuple(shape), mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """16x16 single-pod (256 ranks) or 2x16x16 two-pod (512 ranks) mesh.

    Axes: "data" = FSDP + DP within a pod; "model" = tensor/expert parallel;
    "pod" = pure DP across pods (slow inter-pod links: ZeRO-1 + optional int8
    compressed gradient all-reduce live on this axis).
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_smoke_mesh(n_devices: int | None = None,
                    device_type: Optional[str] = None) -> DeviceMesh:
    """Tiny mesh over the process group's ranks (tests, one card): the
    reference's (n // model, model) split, model the first of 4, 2, 1 that
    divides n."""
    n = n_devices or dist.get_world_size()
    model = 1
    for cand in (4, 2, 1):
        if n % cand == 0:
            model = cand
            break
    return make_mesh((n // model, model), ("data", "model"), device_type)


def elastic_mesh_shape(n_devices: int, prefer_model: int = 16) -> tuple:
    """Elastic re-mesh planning: pick (data, model) for a changed device count
    (node failure / scale-up). Keeps the model axis as close to `prefer_model`
    as divisibility allows, shrinking data-parallel width first — params stay
    shardable, only the batch layout changes."""
    for model in range(min(prefer_model, n_devices), 0, -1):
        if n_devices % model == 0:
            return (n_devices // model, model)
    return (n_devices, 1)


#: each mesh's one-axis sub-meshes, sliced once: (mesh, {axis: sub-mesh}) by
#: the mesh's id (holding the mesh, so the id is not reused)
_SUB_MESHES: dict = {}


def sub_mesh(mesh: DeviceMesh, axis: str) -> DeviceMesh:
    """`mesh[axis]`, sliced at its first use and kept. Slicing runs host
    ops on the mesh's rank tensor (a `nonzero` among them), which a CUDA
    graph's capture refuses (`dispatch.CaptureGuard`), so a body that a
    program captures takes its sub-meshes from here: the program's eager
    first call has sliced them. Two equal meshes over other process groups
    keep their own."""
    entry = _SUB_MESHES.get(id(mesh))
    if entry is None or entry[0] is not mesh:
        entry = _SUB_MESHES[id(mesh)] = (mesh, {})
    subs = entry[1]
    if axis not in subs:
        subs[axis] = mesh[axis]
    return subs[axis]
