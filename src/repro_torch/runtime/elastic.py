"""Elastic scaling: recompute the mesh for a changed device count and
re-place a checkpointed state onto it.

Port of `repro.runtime.elastic`. On a real fleet this runs in the
coordinator after a slice change; here the planner and the resharding
restore are exercised by tests over `gloo` ranks.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import elastic_mesh_shape, make_mesh
from repro_torch.sharding import state_specs, to_named


def plan_mesh(n_devices: int, prefer_model: int = 16,
              device_type: Optional[str] = None):
    shape = elastic_mesh_shape(n_devices, prefer_model)
    return make_mesh(shape, ("data", "model"), device_type)


def restore_on_mesh(
    ckpt: CheckpointManager, step: int, abstract_state: Any,
    cfg: ArchConfig, mesh,
) -> Any:
    """Re-shard a checkpoint onto a (possibly different) mesh."""
    specs = state_specs(cfg, abstract_state, mesh)
    shardings = to_named(mesh, specs)
    return ckpt.restore(step, abstract_state, shardings=shardings)
