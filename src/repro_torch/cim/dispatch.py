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

Every cached program is a `Program`, the port's counterpart of the
reference's `jax.jit`: on CUDA its body is captured as ONE CUDA graph at
the second call with a given leaf signature (the first runs eagerly, so a
program called once, such as a prefill shape seen once, is never
captured) and replayed from then on, one device launch per warm call.
Each call copies its leaves into the graph's static inputs, replays, and
hands the caller clones of the static outputs; what the capture added to
the kernels' launch counters (the fused kernel's launches and bytes, the
flash, RG-LRU and sLSTM kernels' launches) and to the codec counters is
added again at every replay, so counts do not depend on graphs. A program
made with `donate=` (the reference's `donate_argnums`) takes the caller's
own tensors of those leaves as the graph's static inputs and leaves its
new values in them. Graphs of one device share one memory pool (replays
are serialized on the current stream), and a program evicted from the LRU
drops its graphs. Plain devices (`repro_torch.PLAIN_DEVICES`) run the
eager body, as does every program inside `eager_programs()` and a program
called inside another's capture.
A capture runs under `CaptureGuard`, which refuses by name any op a graph
cannot hold; there is no eager fallback. `graph_stats()` counts the eager
first calls on a graph device, the captures and the replays, so a timed
window can tell a steady call from one that compiled.

A program over a mesh (the tiled access, a schedule program over a
`DeviceMesh`, the sharded train step: the reference jits each) follows the
same rule, one graph per rank and signature, with its NCCL collectives
(functional all-gathers, all-reduces and reduce-scatters, DTensor's
redistributes) captured into the graph; `captures` says which meshes a
graph may hold. A mesh is keyed by identity (`mesh_key`): an equal mesh
over new process groups (a re-initialised group, an elastic restore)
gets programs and graphs of its own. A DTensor leaf's signature holds
its mesh and placements too. Every rank captures at the same call,
because every rank makes the same program calls in the same order with
the same signatures: its program table, LRU order and `_seen` sets then
move alike, so no rank captures a collective that another runs eagerly
or replays. The communicators exist before any capture: the eager first
call creates them, or `init_process_group(device_id=)` did. While a
process group exists a capture runs in the thread-local capture mode, so
that the NCCL watchdog's event queries of eager collectives in its own
thread cannot invalidate it (ProcessGroupNCCL records no watchdog work
for a captured collective).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import takes_plain
from repro_torch.core import bitplane
from repro_torch.spans import span
from . import array as array_mod
from . import engine, opset
from .accounting import LEDGER
from .array import DEFAULT_SPEC, ArraySpec, TilePlan
from .backends import Backend, get_backend
from .fused_kernel import fused_planes_op
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
            _, value = self._data.popitem(last=False)
            if isinstance(value, Program):
                value.drop()
            self.evictions += 1

    def clear(self) -> None:
        for value in self._data.values():
            if isinstance(value, Program):
                value.drop()
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
    """Drop every program (and its graphs) and zero the counters, the
    graph counters included."""
    global _DISPATCHES
    _PROGRAMS.clear()
    _DISPATCHES = 0
    _GRAPH_STATS.update(captured=0, replays=0, capture_s=0.0, eager=0)
    _POOLS.clear()


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


# ---------------------------------------------------------------------------
# programs: the eager body, and on CUDA one captured graph per signature
# ---------------------------------------------------------------------------

_EAGER = False
#: a capture is running: programs called inside it run their eager body
_CAPTURING = False
_GRAPH_STATS = {"captured": 0, "replays": 0, "capture_s": 0.0, "eager": 0}
#: one graph memory pool per device: (its handle, the live graphs in it)
_POOLS: Dict[torch.device, tuple] = {}


def _pool(device: torch.device) -> tuple:
    """The device's shared graph pool (handle, live graphs). A pool whose
    graphs have all been freed is released by the caching allocator and
    cannot be captured into again, so it is replaced by a new one."""
    entry = _POOLS.get(device)
    if entry is None or not entry[1]:
        entry = _POOLS[device] = (torch.cuda.graph_pool_handle(),
                                  weakref.WeakSet())
    return entry


def graph_stats() -> Dict[str, float]:
    """Graphs captured, graph replays, the seconds spent capturing and the
    eager first calls a graph device ran (`eager`: a call with a signature
    never seen, which captures nothing but is not steady either) since the
    last `clear_schedule_cache`."""
    return dict(_GRAPH_STATS)


def compiled(before: Dict[str, float], after: Dict[str, float]) -> bool:
    """Whether the calls between two `graph_stats()` readings ran a
    signature's eager first call or captured a graph: such a call is the
    counterpart of the reference's jit compile, and no steady window may
    hold it."""
    return after["captured"] > before["captured"] \
        or after["eager"] > before["eager"]


def _note(stats: Dict[str, float], key: str, n: float = 1) -> None:
    """Add `n` to `key` of a program's own stats and of the global ones."""
    stats[key] += n
    _GRAPH_STATS[key] += n


@contextlib.contextmanager
def eager_programs():
    """Run every program's eager body, on CUDA too: the counterpart of
    `jax.disable_jit`, for tests and equality checks. Graphs already
    captured are kept, and replay again after the context."""
    global _EAGER
    prev, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = prev


def captures(mesh, device: torch.device) -> bool:
    """Whether a program over `mesh` (None: no mesh) may be captured on
    the graph device `device`: with no mesh, on a device that is not CUDA
    (the CPU tests' stand-in graphs), or over a mesh whose groups are all
    NCCL, whose collectives a CUDA graph holds. A program over a gloo mesh
    whose leaves lie on CUDA is refused at its capture (`Program`), not
    run eagerly."""
    if mesh is None or device.type != "cuda" \
            or not hasattr(mesh, "get_all_groups"):
        return True
    import torch.distributed as dist

    return all("nccl" in str(dist.get_backend(g))
               for g in mesh.get_all_groups())


def mesh_key(mesh):
    """A mesh as part of a program's key: by identity, since two equal
    meshes may stand on different process groups (a graph replays the
    communicator it captured). The key holds the mesh, so its id is not
    reused while the key lives."""
    return None if mesh is None else (mesh, id(mesh))


_TENSOR = object()          # the slot of one tensor in a template


def _flatten(obj, out: List[torch.Tensor]):
    """Append the tensors of a program's leaves or result (tensors,
    PlanePacks, tuples, lists and dicts of them; anything else is a
    constant) to `out`, and return the template `_unflatten` rebuilds it
    from."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
        return _TENSOR
    if isinstance(obj, PlanePack):
        out.append(obj.planes)
        return dataclasses.replace(obj, planes=None)
    if isinstance(obj, (tuple, list)):
        return (type(obj), [_flatten(x, out) for x in obj])
    if isinstance(obj, dict):
        return (dict, [(k, _flatten(v, out)) for k, v in obj.items()])
    return obj


def _unflatten(template, tensors):
    """`template` with its tensor slots filled from the iterator
    `tensors`, in `_flatten`'s order."""
    if template is _TENSOR:
        return next(tensors)
    if isinstance(template, PlanePack):
        return dataclasses.replace(template, planes=next(tensors))
    if isinstance(template, tuple) and len(template) == 2:
        if template[0] in (tuple, list):
            return template[0](_unflatten(t, tensors) for t in template[1])
        if template[0] is dict:
            return {k: _unflatten(t, tensors) for k, t in template[1]}
    return template


def _graph_device(tensors: Sequence[torch.Tensor]) -> Optional[torch.device]:
    """The CUDA device a call with these leaf tensors replays on, or None
    to run the eager body: inside `eager_programs`, or when every leaf lies
    on a plain device. A leaf on the CPU beside CUDA leaves is copied to
    the graph's device."""
    if _EAGER:
        return None
    devices = {t.device for t in tensors if not takes_plain(t)}
    if len(devices) > 1:
        raise opset.CimOpError(
            f"a program's leaves lie on {sorted(map(str, devices))}: a "
            f"graph runs on one device")
    return devices.pop() if devices else None


_KERNEL_WRAPPERS: List = []


def _wrappers() -> List:
    """The float kernels' wrappers whose `launches` a body bumps: flash
    attention (wgmma/TMA, SIMT), RG-LRU (TMA tiles, rows) and sLSTM
    (persistent grid, rows). Imported at first use: `repro_torch.kernels`
    imports the CiM engine."""
    if not _KERNEL_WRAPPERS:
        from repro_torch.kernels import flash_attention, rglru, slstm

        _KERNEL_WRAPPERS.extend((
            flash_attention.flash_attention_sm90,
            flash_attention.flash_attention_simt, rglru.rglru_sm90,
            rglru.rglru_rows, slstm.slstm_sm90, slstm.slstm_rows))
    return _KERNEL_WRAPPERS


def _counters() -> Tuple[int, ...]:
    """The counters a body bumps from Python, which a replay does not run:
    the fused kernel's launches and bytes, the codec's packs and unpacks,
    and the float kernels' launches (`_wrappers`)."""
    codec = bitplane._CODEC_CALLS
    return (fused_planes_op.launches, fused_planes_op.bytes,
            codec["pack"], codec["unpack"]) \
        + tuple(w.launches for w in _wrappers())


def _add_counters(delta: Tuple[int, ...]) -> None:
    codec = bitplane._CODEC_CALLS
    fused_planes_op.launches += delta[0]
    fused_planes_op.bytes += delta[1]
    codec["pack"] += delta[2]
    codec["unpack"] += delta[3]
    for w, d in zip(_wrappers(), delta[4:]):
        w.launches += d


_LIFTS = ("lift_fresh", "lift_fresh_copy", "lift")
_EMPTY = ("empty", "empty_strided", "empty_like")
_INDEXING = ("index", "index_put", "index_put_", "_index_put_impl_")


def _capture_refusal(func, args, kwargs, device) -> Optional[str]:
    """Why a graph cannot hold one aten call, or None."""
    name = func.overloadpacket.__name__
    if name in _LIFTS:
        return "it builds a tensor from host data"
    if torch.Tag.data_dependent_output in func.tags:
        return "it reads a device value on the host"
    if name in _INDEXING:
        # tagged dynamic_output_shape, but only a boolean index is
        if any(i is not None and i.dtype in (torch.bool, torch.uint8)
               for i in args[1]):
            return "a boolean index gives a shape that depends on the data"
    elif torch.Tag.dynamic_output_shape in func.tags:
        return "its output's shape depends on the data"
    # a view (`detach` included) reads no data: `torch.utils.checkpoint`
    # detaches its host placeholders
    if device is not None and not func.is_view:
        flat = list(args) + list(kwargs.values())
        flat += [x for a in flat if isinstance(a, (tuple, list)) for x in a]
        for x in flat:
            if isinstance(x, torch.Tensor) and x.device != device:
                return f"it reads a tensor on {x.device}, not on {device}"
        dev = kwargs.get("device")
        # an uninitialized host tensor holds no data a graph could freeze
        # (`torch.utils.checkpoint` makes such placeholders)
        if dev is not None and torch.device(dev).type != device.type \
                and name not in _EMPTY:
            return f"it makes a tensor on {dev}, not on {device}"
    return None


class CaptureGuard(TorchDispatchMode):
    """Refuses, by name, every aten call a CUDA graph cannot hold: one that
    reads a device value on the host (`aten._local_scalar_dense`: `.item()`,
    `.tolist()`; every op tagged data_dependent_output), builds a tensor
    from host data (`aten.lift_fresh`: `torch.tensor`, `torch.as_tensor` of
    a Python value), gives an output whose shape depends on the data (ops
    tagged dynamic_output_shape: `nonzero`, `masked_select`, boolean
    indexing) or, with a `device`, reads a tensor on another device (a
    view reads nothing) or makes one there with data (an empty host
    placeholder passes). Every capture runs under it; the CPU tests run
    warm bodies under it without a device, and on `meta` with one.

    Over a mesh it sees ops at the DTensor level: a DTensor op itself (its
    `.item()` is refused by name, as `aten._local_scalar_dense` of a
    DTensor), and the functional collectives of an explicit
    `redistribute` or `full_tensor` that a body calls (they run on local
    tensors from Python). It does not see the local ops that DTensor's own
    dispatch runs for an op (the mode is off inside its handler): an
    implicit redistribute, such as the all-reduce that turns a `Partial`
    sum `Replicate`, or a host read there, would reach CUDA's capture
    unchecked and fail as CUDA's own capture error, not as a named
    refusal (`tests/_torch_gloo_ranks.py::case_capture_guard`)."""

    def __init__(self, device: Optional[torch.device] = None):
        super().__init__()
        self.device = device

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        why = _capture_refusal(func, args, kwargs, self.device)
        if why is not None:
            raise opset.CimOpError(
                f"{func} cannot be captured in a CUDA graph: {why}")
        return func(*args, **kwargs)


def _distributed() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor, a plain tensor itself: a copy into a
    static input of the same mesh and placements stays on this rank."""
    return getattr(t, "_local_tensor", t)


def _record(fn, args, device: torch.device):
    """Capture `fn(*args)` as one CUDA graph on `device`, in the device's
    shared pool (on `torch.cuda.graph`'s one capture stream, as sharing a
    pool asks), under `CaptureGuard`. Returns (graph, result); the graph
    has not run yet."""
    global _CAPTURING
    pool, live = _pool(device)
    graph = torch.cuda.CUDAGraph()
    # beside a process group, capture in the thread-local mode: the NCCL
    # watchdog thread queries eager collectives' events meanwhile
    mode = "thread_local" if _distributed() else "global"
    _CAPTURING = True
    try:
        with torch.cuda.device(device), \
                torch.cuda.graph(graph, pool=pool, capture_error_mode=mode), \
                CaptureGuard(device):
            out = fn(*args)
    finally:
        _CAPTURING = False
    live.add(graph)
    return graph, out


class _Graph:
    """One captured body: its static inputs (one per leaf tensor; a donated
    leaf's are the capturing caller's own tensors), the graph, its static
    outputs with the template they rebuild (outputs that are static inputs
    are handed back as they are, the rest cloned), and what the capture
    added to `_counters`."""

    __slots__ = ("graph", "inputs", "outputs", "template", "counts",
                 "shared")

    def __init__(self, fn, tensors, template, device, donated, stats):
        self.inputs = []
        for t, own in zip(tensors, donated):
            if own:
                self.inputs.append(t)
            else:
                # a DTensor's is a DTensor of its mesh and placements
                self.inputs.append(torch.empty_like(t, device=device))
                _local(self.inputs[-1]).copy_(_local(t))
        before = _counters()
        t0 = time.perf_counter()
        self.graph, out = _record(fn, _unflatten(template, iter(self.inputs)),
                                  device)
        _note(stats, "capture_s", time.perf_counter() - t0)
        _note(stats, "captured")
        # the capture launched nothing: its counts belong to the replays
        after = _counters()
        self.counts = tuple(b - a for a, b in zip(before, after))
        _add_counters(tuple(-c for c in self.counts))
        self.outputs = []
        self.template = _flatten(out, self.outputs)
        # the donated leaves' own tensors go back as they are
        ids = {id(s) for s, own in zip(self.inputs, donated) if own}
        self.shared = [id(o) in ids for o in self.outputs]

    def __call__(self, tensors, stats):
        with span("repro.graph.copy_in"):
            for s, t in zip(self.inputs, tensors):
                if s is not t:
                    _local(s).copy_(_local(t))
        with span("repro.graph.replay"):
            self.graph.replay()
        _note(stats, "replays")
        _add_counters(self.counts)
        with span("repro.graph.copy_out"):
            return _unflatten(self.template, iter([
                o if shared else o.clone()
                for o, shared in zip(self.outputs, self.shared)]))


def _pairs(old, new, out: List[Tuple[torch.Tensor, torch.Tensor]]) -> bool:
    """Append (leaf tensor, new tensor) for each tensor of the donated leaf
    `old`, walking `new` alongside (dicts by key); False where the two
    differ in structure, shape or dtype."""
    if isinstance(old, torch.Tensor):
        out.append((old, new))
        return isinstance(new, torch.Tensor) and new.shape == old.shape \
            and new.dtype == old.dtype
    if isinstance(old, PlanePack):
        return isinstance(new, PlanePack) and _pairs(old.planes, new.planes,
                                                     out)
    if isinstance(old, (tuple, list)):
        return isinstance(new, (tuple, list)) and len(new) == len(old) \
            and all(_pairs(a, b, out) for a, b in zip(old, new))
    if isinstance(old, dict):
        return isinstance(new, dict) and new.keys() == old.keys() \
            and all(_pairs(old[k], new[k], out) for k in old)
    return True


def _donating(fn, donate: Tuple[int, ...]):
    """`fn` that leaves the new value of each donated leaf in the leaf's
    own tensors: the body's result `i` is leaf `i`'s new value, of the same
    structure, shapes and dtypes; each of its tensors that is not already
    the leaf's is copied into it, and the leaf itself takes its place in
    the result."""
    def run(*leaves):
        out = list(fn(*leaves))
        for i in donate:
            pairs: List[Tuple[torch.Tensor, torch.Tensor]] = []
            if not _pairs(leaves[i], out[i], pairs):
                raise opset.CimOpError(
                    f"donated leaf {i}: the body's result {i} does not "
                    f"match its structure, shapes and dtypes")
            for a, b in pairs:
                if a is not b:
                    a.copy_(b)
            out[i] = leaves[i]
        return tuple(out)
    return run


class Program:
    """One cached program: `fn(*leaves)`, its leaves tensors, PlanePacks
    and tuples, lists and dicts of them.

    A call with a leaf signature (shapes and dtypes; a DTensor's mesh and
    placements too) never seen runs the eager body; on CUDA the second
    call with it captures the body as one graph and every later call
    replays that graph (the reference's jit retraces per shape too). Plain
    devices, `eager_programs()` and a call inside another program's
    capture run the eager body. `mesh` is the mesh a body's collectives
    run over (the tiled access's, a schedule's, the sharded train step's):
    a capture over a mesh that `captures` refuses raises. `first` names
    the leaves of a call already made eagerly (a schedule program's
    recording call).

    `donate` (the reference's `donate_argnums`) names leaves whose tensors
    the program takes over: the body returns a tuple whose item `i` is
    donated leaf `i`'s new value, and the program leaves that value in the
    leaf's own tensors (inside the graph, so a replay does too) and returns
    those tensors in its place, not clones. The capture keeps the
    capturing call's tensors of a donated leaf as static inputs, so a later
    call with the same tensors copies nothing in; a call with other tensors
    has them copied in (a DTensor's local tensor into the static input's).
    `stats` counts this program's eager first calls (on a graph device),
    captures, capture seconds and replays."""

    __slots__ = ("fn", "mesh", "_seen", "graphs", "donate", "stats")

    def __init__(self, fn, first=None, donate: Sequence[int] = (),
                 mesh=None):
        self.donate = tuple(donate)
        self.fn = _donating(fn, self.donate) if self.donate else fn
        self.mesh = mesh
        self._seen = set()
        self.graphs: Dict[Tuple, _Graph] = {}
        self.stats = {"captured": 0, "replays": 0, "capture_s": 0.0,
                      "eager": 0}
        if first is not None:
            tensors: List[torch.Tensor] = []
            _flatten(tuple(first), tensors)
            self._seen.add(_signature(tensors))
            if _graph_device(tensors) is not None:
                _note(self.stats, "eager")

    def __call__(self, *leaves):
        if _CAPTURING:
            return self.fn(*leaves)
        tensors: List[torch.Tensor] = []
        template = _flatten(leaves, tensors)
        device = _graph_device(tensors)
        if device is None:
            return self.fn(*leaves)
        sig = _signature(tensors)
        graph = self.graphs.get(sig)
        if graph is None:
            if sig not in self._seen:
                self._seen.add(sig)
                _note(self.stats, "eager")
                return self.fn(*leaves)
            meshes = {self.mesh} | {t.device_mesh for t in tensors
                                    if _placements(t) is not None}
            for m in meshes:
                if not captures(m, device):
                    raise opset.CimOpError(
                        f"a program over a mesh of non-NCCL groups has "
                        f"leaves on {device}: a CUDA graph cannot hold its "
                        f"collectives")
            donated: List[bool] = []
            for i, leaf in enumerate(leaves):
                n: List[torch.Tensor] = []
                _flatten(leaf, n)
                donated += [i in self.donate] * len(n)
            graph = self.graphs[sig] = _Graph(self.fn, tensors, template,
                                              device, donated, self.stats)
        return graph(tensors, self.stats)

    def drop(self) -> None:
        """Release the graphs (and their static buffers)."""
        self.graphs.clear()


def _placements(t: torch.Tensor):
    """A DTensor's placements, None for a plain tensor."""
    return getattr(t, "placements", None)


def _signature(tensors: Sequence[torch.Tensor]) -> Tuple:
    """Shapes and dtypes; a DTensor's mesh and placements too, so that a
    `Shard(0)` and a `Replicate()` leaf of one global shape, or one leaf
    on two meshes, get graphs of their own."""
    return tuple((tuple(t.shape), t.dtype) if _placements(t) is None else
                 (tuple(t.shape), t.dtype, mesh_key(t.device_mesh),
                  tuple(t.placements)) for t in tensors)


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
    `axis` (a functional all-gather, captured into the program's graph on
    NCCL)."""
    if mesh is None:
        return lambda ta, tb: bk(ta, tb, ops)
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch.mesh import sub_mesh

    n_dev, coord = _mesh_axis(mesh, axis)
    sub = sub_mesh(mesh, axis)

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
    the key: the same tile shape is the same program (one graph per tile
    count). The mesh is, by identity (`mesh_key`): two meshes of the same
    shape over other ranks or other groups must not share one."""
    key = (ops, n_bits, tile_shape, bk.name,
           None if mesh is None else (mesh_key(mesh), axis))
    prog = program_cache_get(key)
    if prog is None:
        prog = Program(_tiled_program(ops, bk, mesh, axis), mesh=mesh)
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
