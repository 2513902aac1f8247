"""Tiling dispatcher: run any PlanePack op request on a banked array.

Port of `repro.cim.dispatch` for one device. `execute_tiled` splits an
operand pair into bank-sized tiles (ArraySpec / TilePlan from
`repro_torch.cim.array`), runs the backend once over the whole
[T, n_bits, lanes] tile stack — the fused kernel walks the tile axis in its
grid, as the reference's vmap does — and stitches the outputs back
together. It is bit-exact with the untiled engine: elementwise CiM ops touch
each word independently and tiles cut the packed lane axis on uint32
boundaries. The ledger is charged one activation per tile, attributed to
its (device, bank) slot. With a mesh (a `DeviceMesh` of
`repro_torch.launch.mesh`, the reference's shard_map path), the tile axis
is padded to a multiple of the `axis` size and block-distributed over its
ranks: each rank runs its own block of tiles through the backend on its
device, the raw output planes are all-gathered over the axis, and every
rank's ledger is charged the whole access with each tile on its
(device, bank) slot, as the reference's one controller charges it. An
installed fault model corrupts the streamed operands of the eager
`execute_tiled` (BER flips and the stuck-at rows of the banks its tiles
land on); the traced form a schedule program runs never injects.

The module also holds the compiled-schedule cache: a bounded LRU of
programs keyed by schedule structure. It holds the per-access tiled
programs built here (key: ops, n_bits, tile shape, backend, mesh) and the
whole-schedule programs of `repro_torch.cim.macro` (one `CompiledSchedule`
per key). `cache_stats()` exposes hit/miss/eviction counters and
`dispatches`, the number of program invocations — the deterministic
walltime proxy (a warm macro is exactly one). The capacity is 256 unless
REPRO_CIM_CACHE_CAPACITY (the reference's variable) or
`set_schedule_cache_capacity` says otherwise.
"""
from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from typing import Dict, Optional, Sequence

import torch

from . import array as array_mod
from . import engine, opset
from .accounting import LEDGER
from .array import DEFAULT_SPEC, ArraySpec, TilePlan
from .backends import Backend, get_backend
from .planepack import PlanePack

#: program-table capacity (the reference's default)
_DEFAULT_CAPACITY = 256


class BoundedLRU:
    """Move-to-front bounded mapping with hit/miss/eviction counters. An
    insert past capacity evicts the coldest entry; correctness never
    depends on residency."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        self.capacity = _checked(capacity)
        self._data: "OrderedDict[object, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key, default=None):
        """Look up, counting a hit (and refreshing recency) or a miss.
        Callers that miss MUST build and `put` under the same key."""
        if key in self._data:
            self.hits += 1
            self._data.move_to_end(key)
            return self._data[key]
        self.misses += 1
        return default

    def put(self, key, value) -> None:
        self._data[key] = value
        self._data.move_to_end(key)
        self._evict()

    def set_capacity(self, capacity: int) -> None:
        self.capacity = _checked(capacity)
        self._evict()

    def _evict(self) -> None:
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)
            self.evictions += 1

    def clear(self) -> None:
        self._data.clear()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def items(self):
        return self._data.items()

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._data), "evictions": self.evictions,
                "capacity": self.capacity}

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data


def _checked(capacity: int) -> int:
    if capacity < 1:
        raise opset.CimOpError(f"cache capacity must be >= 1, got {capacity}")
    return int(capacity)


def _env_capacity() -> int:
    """REPRO_CIM_CACHE_CAPACITY; a malformed or < 1 value falls back to the
    default instead of disabling the cache or failing the import."""
    raw = os.environ.get("REPRO_CIM_CACHE_CAPACITY")
    if raw is None:
        return _DEFAULT_CAPACITY
    try:
        cap = int(raw)
    except ValueError:
        return _DEFAULT_CAPACITY
    return cap if cap >= 1 else _DEFAULT_CAPACITY


_PROGRAMS = BoundedLRU(_env_capacity())
_DISPATCHES = 0


def cache_stats() -> Dict[str, int]:
    """Program-table hits/misses/evictions, `dispatches` (program
    invocations), the aggregated resident-region counters and the fault
    layer's injection/ECC counters."""
    from . import faults as faults_mod

    stats = _PROGRAMS.stats()
    stats["dispatches"] = _DISPATCHES
    stats.update(array_mod.resident_stats())
    stats.update(faults_mod.fault_stats())
    return stats


def clear_schedule_cache() -> None:
    global _DISPATCHES
    _PROGRAMS.clear()
    _DISPATCHES = 0


def set_schedule_cache_capacity(capacity: int) -> None:
    """Bound the program table to `capacity` entries (>= 1); the least
    recently used programs are evicted at once if it holds more."""
    _PROGRAMS.set_capacity(capacity)


def count_dispatch(n: int = 1) -> None:
    """Record `n` program invocations (see cache_stats)."""
    global _DISPATCHES
    _DISPATCHES += n


def program_cache_get(key):
    """Look up a program, counting a hit or a miss. Callers that miss MUST
    build and `program_cache_put` under the same key."""
    return _PROGRAMS.get(key)


def program_cache_put(key, prog) -> None:
    _PROGRAMS.put(key, prog)


def _mesh_axis(mesh, axis: str):
    """(size, this rank's coordinate) of the mesh axis the tiles spread
    over; a mesh without it is refused."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if axis not in names:
        raise opset.CimOpError(f"mesh has axes {names}, no {axis!r}")
    return mesh.size(names.index(axis)), mesh.get_local_rank(axis)


def _tiled_program(ops, bk: Backend, mesh=None, axis: Optional[str] = None):
    """One access over a whole tile stack: the backend's own [T, n, lanes]
    form (the fused kernel's grid walks the tile axis). With a mesh, this
    rank's block of the tiles, then the raw planes all-gathered over
    `axis`."""
    if mesh is None:
        return lambda ta, tb: bk(ta, tb, ops)
    from torch.distributed.tensor import DTensor, Shard

    n_dev, coord = _mesh_axis(mesh, axis)
    sub = mesh[axis]

    def run(ta, tb):
        per = ta.shape[0] // n_dev
        local = bk(ta[coord * per:(coord + 1) * per],
                   tb[coord * per:(coord + 1) * per], ops)
        return tuple(DTensor.from_local(r.contiguous(), sub, [Shard(0)],
                                        run_check=False).full_tensor()
                     for r in local)
    return run


def _cached_program(ops, n_bits: int, tile_shape: tuple, bk: Backend,
                    mesh=None, axis: Optional[str] = None):
    """The tiled program of one schedule key. The bank count is not part of
    the key: the same tile shape is the same program. The mesh is (two
    meshes of the same shape over other ranks must not share one)."""
    key = (ops, n_bits, tile_shape, bk.name,
           None if mesh is None else (mesh, axis))
    prog = program_cache_get(key)
    if prog is None:
        prog = _tiled_program(ops, bk, mesh, axis)
        program_cache_put(key, prog)
    return prog


# ---------------------------------------------------------------------------
# tile / untile (packed lane axis, uint32 boundaries)
# ---------------------------------------------------------------------------


def _tile(planes: torch.Tensor, plan: TilePlan,
          n_tiles: Optional[int] = None) -> torch.Tensor:
    """[n_bits, W] -> contiguous [n_tiles, n_bits, lanes_per_tile]
    (`n_tiles` defaults to the plan's; the last tile's pad lanes and any
    pad tiles are zero): one pass over the planes."""
    n_bits, w = planes.shape
    lanes = plan.lanes_per_tile
    n_tiles = plan.n_tiles if n_tiles is None else n_tiles
    full = w // lanes
    out = planes.new_empty((n_tiles, n_bits, lanes))
    if full:
        out[:full].copy_(planes[:, :full * lanes]
                         .reshape(n_bits, full, lanes).transpose(0, 1))
    if full < n_tiles:
        out[full:].zero_()
    if full * lanes < w:
        out[full, :, :w - full * lanes].copy_(planes[:, full * lanes:])
    return out


def _untile(raw: torch.Tensor, w: int) -> torch.Tensor:
    """[n_tiles, rows, lanes] -> contiguous [rows, W] (pad lanes dropped)."""
    n_tiles, rows, lanes = raw.shape
    full = w // lanes
    out = raw.new_empty((rows, w))
    if full:
        out[:, :full * lanes].view(rows, full, lanes).copy_(
            raw[:full].transpose(0, 1))
    if full * lanes < w:
        out[:, full * lanes:].copy_(raw[full, :, :w - full * lanes])
    return out


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------


def _prepare_tiles(a: PlanePack, b: PlanePack, ops: Sequence[str],
                   spec: Optional[ArraySpec], mesh, axis: str):
    """The shared front half of the tiled paths: operand alignment, the
    rows budget beside the resident region, placement and tile stacks (the
    tile axis padded to a multiple of the mesh axis; pad tiles hold no
    operands and are not charged)."""
    n_devices = 1
    if mesh is not None:
        n_devices = _mesh_axis(mesh, axis)[0]
    a, b, ops = engine.prepare_operands(a, b, ops)
    spec = spec or DEFAULT_SPEC
    spec.check_fits(a.n_bits, ops,
                    resident_rows=array_mod.resident_rows_for(spec))
    plan = spec.plan(a.n_words)
    exec_tiles = -(-plan.n_tiles // n_devices) * n_devices
    return (a, b, ops, plan, n_devices, _tile(a.planes, plan, exec_tiles),
            _tile(b.planes, plan, exec_tiles))


def _fault_overlay(a: PlanePack, b: PlanePack, plan: TilePlan, ta, tb):
    """Transient-fault injection on the streamed operands of one eager
    tiled access (BER flips and stuck-at rows of the active FaultModel)."""
    from . import faults as faults_mod

    fm = faults_mod.active()
    if fm is None or (fm.config.ber <= 0.0 and not fm.config.stuck):
        return a, b, ta, tb
    pa, na = fm.corrupt_streamed(a.planes, plan)
    pb, nb = fm.corrupt_streamed(b.planes, plan)
    if na:
        a = dataclasses.replace(a, planes=pa)
        ta = _tile(a.planes, plan, ta.shape[0])
    if nb:
        b = dataclasses.replace(b, planes=pb)
        tb = _tile(b.planes, plan, tb.shape[0])
    return a, b, ta, tb


def _wrap_tiled(a: PlanePack, ops, raws) -> engine.Outputs:
    w = a.planes.shape[1]
    return {op: engine._wrap(op, _untile(raw, w), a.n_bits, a.shape)
            for op, raw in zip(ops, raws)}


def execute_tiled(a: PlanePack, b: PlanePack, ops: Sequence[str],
                  spec: Optional[ArraySpec] = None,
                  backend: Optional[str] = None,
                  mesh=None, axis: str = "data") -> engine.Outputs:
    """One logical ADRA access on a banked array (the paper's DEFAULT_SPEC
    when `spec` is None): bank-sized tiles, one backend call over them all
    (with `mesh`, one per rank of its `axis` over its block of tiles).

    Bit-exact with `engine.execute`; the ledger is charged one activation
    per tile, attributed to its (device, bank), and the last tile's idle
    columns as activated-but-idle words. One dispatch."""
    a, b, ops, plan, n_devices, ta, tb = _prepare_tiles(a, b, ops, spec,
                                                        mesh, axis)
    a, b, ta, tb = _fault_overlay(a, b, plan, ta, tb)
    bk = get_backend(backend)
    raws = _cached_program(ops, a.n_bits, tuple(ta.shape[1:]), bk, mesh,
                           axis if mesh is not None else None)(ta, tb)
    count_dispatch()      # invoke first, account after (as CompiledSchedule)
    LEDGER.charge_banked(ops, a.n_bits, a.n_words, plan, n_devices=n_devices)
    return _wrap_tiled(a, ops, raws)


def execute_tiled_traced(a: PlanePack, b: PlanePack, ops: Sequence[str],
                         spec: Optional[ArraySpec] = None,
                         backend: Optional[str] = None, mesh=None,
                         axis: str = "data",
                         charges: Optional[list] = None) -> engine.Outputs:
    """The side-effect-free inner form of `execute_tiled` for a schedule
    program: no cache lookup, no dispatch count, no ledger mutation. With
    `charges`, appends the record `execute_tiled` would have charged."""
    a, _, ops, plan, n_devices, ta, tb = _prepare_tiles(a, b, ops, spec,
                                                        mesh, axis)
    raws = _tiled_program(ops, get_backend(backend), mesh,
                          axis if mesh is not None else None)(ta, tb)
    if charges is not None:
        charges.append(("banked", ops, a.n_bits, a.n_words, plan,
                        n_devices))
    return _wrap_tiled(a, ops, raws)


def execute_sharded(a: PlanePack, b: PlanePack, ops: Sequence[str], mesh,
                    spec: Optional[ArraySpec] = None,
                    backend: Optional[str] = None,
                    axis: str = "data") -> engine.Outputs:
    """`execute_tiled` with a mandatory mesh (the multi-device entry point —
    make_smoke_mesh / make_production_mesh from repro_torch.launch.mesh)."""
    return execute_tiled(a, b, ops, spec=spec, backend=backend,
                         mesh=mesh, axis=axis)
