"""Whole-schedule compiled execution in the port: each cached program
captured as one CUDA graph (DESIGN.md §8, the port's `jax.jit`).

The CPU has no CUDA graph, so these cases inject a stand-in: the program
path is taken on CPU tensors and `dispatch._record` returns a graph whose
replay recomputes the captured body on its static inputs into its static
outputs and, like a real replay, runs no Python side effect (the counters
its rerun bumps are set back). The capture itself runs under
`dispatch.CaptureGuard`, as on the card, so every body captured here
passes the checks a CUDA capture makes: no host read of a device value, no
tensor built from host data, no output whose shape depends on the data.

(a) capture safety: the guard refuses what a graph cannot hold; every
    macro of `cim/macro.py` (fused and analog-oracle backends, unbanked
    and banked) and every region of the 2-layer bench decode step
    (streamed, resident, `--sampler adra`) captures under it and replays
    to the bit of the eager body;
(b) the program's bookkeeping: launch, byte and codec counters replay on
    every call, and so do the float kernels' launch counters (flash,
    RG-LRU, sLSTM); eager first calls are counted, so a timed window can
    tell them from steady calls; a program inside another's capture runs
    eagerly; dict leaves round-trip; successive results do not alias, new
    leaf values give new results, eviction drops the graph, a program over
    a mesh is graphed and keyed on the mesh by identity (the tiled access
    over a one-rank mesh too), DTensor leaves key on their mesh and
    placements, the tiled program keeps one graph per tile count, a body
    that cannot be captured raises, and dispatch/hit/miss counts and
    ledgers move as the reference's do (`tests/test_cim_program.py:48-93`,
    same inputs);
plus the port's public surface: every public name of the reference's
package `__init__`s resolves in the port's, with the listed departures.
"""
import ast
import dataclasses
import runpy
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_stand_in

from repro import cim as rcim
from repro.cim import dispatch as rdisp
from repro.cim import macro as rmacro
from repro.cim import planner as rplan
from repro.cim.accounting import LEDGER as RLEDGER
from repro.cim.planepack import PlanePack as RPack
from repro.configs import registry as rreg
from repro.models import model as rmodel
from repro_torch import cim as tcim
from repro_torch.cim import array as tarray
from repro_torch.cim import backends as tbk
from repro_torch.cim import dispatch as tdisp
from repro_torch.cim import engine as teng
from repro_torch.cim import macro as tmacro
from repro_torch.cim import planner as tplan
from repro_torch.cim.accounting import LEDGER as TLEDGER
from repro_torch.cim.fused_kernel import fused_planes_op, fused_planes_op_ref
from repro_torch.cim.opset import CimOpError
from repro_torch.cim.planepack import PlanePack as TPack
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.models import model as tmodel
from repro_torch.models.model import build

ROOT = Path(__file__).resolve().parents[1]

#: a small banked geometry: 70-word operands place 3 tiles over 2 banks
SPEC_KW = dict(banks=2, subarrays=1, rows=256, bitline_words=32)
TSPEC = tarray.ArraySpec(**SPEC_KW)


@pytest.fixture(autouse=True)
def _fresh_state():
    for clear in (TLEDGER.reset, tarray.clear_resident,
                  tdisp.clear_schedule_cache, rdisp.clear_schedule_cache):
        clear()
    yield
    for clear in (TLEDGER.reset, tarray.clear_resident,
                  tdisp.clear_schedule_cache, rdisp.clear_schedule_cache):
        clear()


@pytest.fixture
def stand_in():
    """Programs on CPU tensors take the graph path, captured (under the
    capture guard) into stand-in graphs; returns the list of captures."""
    with _torch_stand_in.stand_in() as graphs:
        yield graphs


@pytest.fixture
def counting(monkeypatch):
    """A backend that counts launches and bytes as the kernel's wrapper
    does, on the plain version's arithmetic."""

    def fn(a, b, ops):
        outs = fused_planes_op_ref(a, b, tuple(ops))
        fused_planes_op.launches += 1
        fused_planes_op.bytes += 4 * sum(t.numel() for t in (a, b) + outs)
        return outs

    monkeypatch.setitem(tbk._REGISTRY, "test-counting",
                        tbk.Backend("test-counting", fn, "counts launches"))
    return "test-counting"


def _ints(rng, lo, hi, shape):
    return torch.from_numpy(rng.randint(lo, hi, shape).astype(np.int32))


def _counts():
    return tdisp._counters() + (tdisp.cache_stats()["dispatches"],
                                TLEDGER.accesses)


def _delta(before, after):
    return tuple(b - a for a, b in zip(before, after))


def _same(x, y):
    xs, ys = [], []
    tdisp._flatten(x, xs)
    tdisp._flatten(y, ys)
    return len(xs) == len(ys) and all(torch.equal(a, b) for a, b in zip(xs, ys))


# ---------------------------------------------------------------------------
# (a) capture safety
# ---------------------------------------------------------------------------

_X = torch.arange(10)


@pytest.mark.parametrize("what,call", [
    ("_local_scalar_dense", lambda: _X.sum().item()),
    ("lift_fresh", lambda: torch.tensor(3)),
    ("lift_fresh", lambda: torch.as_tensor(0.83, dtype=torch.float32)),
    ("nonzero", lambda: _X.nonzero()),
    ("index", lambda: _X[_X > 3]),
    ("index_put", lambda: _X.clone().index_put_(
        (_X > 3,), torch.zeros((), dtype=_X.dtype))),
    ("masked_select", lambda: torch.masked_select(_X, _X > 3)),
    ("unique", lambda: torch.unique(_X)),
])
def test_guard_refuses_what_a_graph_cannot_hold(what, call):
    with pytest.raises(CimOpError, match=what):
        with tdisp.CaptureGuard():
            call()


def test_guard_lets_integer_indexing_and_fills_through():
    idx = torch.tensor([3, 1])
    with tdisp.CaptureGuard():
        picked = _X[idx]
        filled = torch.full((), 0.83, dtype=torch.float32)
        where = torch.where(_X > 3, 0.25, 1.45)
        shifted = torch.arange(4) << 2
    assert picked.tolist() == [3, 1] and shifted.tolist() == [0, 4, 8, 12]
    assert torch.equal(filled, torch.as_tensor(0.83, dtype=torch.float32))
    assert where.dtype == torch.float32


def test_guard_with_a_device_refuses_host_data_but_not_placeholders():
    """Capturing for a device, the guard refuses a host tensor read by an
    op and one made there with data, and lets an empty host placeholder
    and a view of a host tensor through (`torch.utils.checkpoint` makes
    and detaches such placeholders each call)."""
    meta = torch.device("meta")
    host = torch.ones(3)
    x = torch.empty(3, device=meta)
    with tdisp.CaptureGuard(meta):
        torch.empty((0,), device="cpu", requires_grad=True).detach()
        host.view(3, 1)
        x + x
        with pytest.raises(CimOpError, match="makes a tensor on cpu"):
            torch.zeros(2, device="cpu")
        with pytest.raises(CimOpError, match="reads a tensor on cpu"):
            torch.add(x, host)


def _macro_cases():
    rng = np.random.RandomState(7)
    x, y = _ints(rng, -100, 100, 70), _ints(rng, -100, 100, 70)
    a, b = _ints(rng, -128, 128, (5, 12)), _ints(rng, -128, 128, (12, 3))
    ba, bb = _ints(rng, -128, 128, (2, 3, 9)), _ints(rng, -128, 128, (2, 9, 4))
    pa, pb = TPack.pack(x, 8), TPack.pack(y, 8)
    ra = TPack.pack(_ints(rng, -100, 100, 70), 8, signed=False)
    return {
        "multiply": (tmacro.multiply, (pa, pb), {}),
        "abs": (tmacro.abs_, (pa,), {}),
        "relu": (tmacro.relu, (pa,), {}),
        "minimum": (tmacro.minimum, (pa, pb), {}),
        "maximum": (tmacro.maximum, (pa, pb), {}),
        "popcount": (tmacro.popcount, (ra,), {}),
        "reduce_sum": (tmacro.reduce_sum, (pa,), {}),
        "matmul": (tmacro.matmul, (a, b), {}),
        "matmul_resident": (tmacro.matmul, (a, None),
                            {"b_pack": tmacro.matmul_rhs_pack(b, 5, 8)}),
        "batched_matmul": (tmacro.batched_matmul, (ba, bb), {}),
        "batched_matmul_resident": (
            tmacro.batched_matmul, (ba, None),
            {"b_pack": tmacro.batched_matmul_rhs_pack(bb, 3, 8)}),
        "dot": (tmacro.dot, (x[:16], y[:16]), {}),
    }


MACROS = tuple(_macro_cases())


@pytest.mark.parametrize("backend,spec", [("fused", None),
                                          ("fused", TSPEC),
                                          ("analog-oracle", None)],
                         ids=["fused", "fused-banked", "analog"])
@pytest.mark.parametrize("name", MACROS)
def test_macro_body_captures_and_replays_to_the_bit(stand_in, name, backend,
                                                    spec):
    """Cold call eager, the warm call captured under the guard, a third
    replayed: each result, ledger and counter delta equal to the eager
    body's (run inside `eager_programs`)."""
    fn, args, kw = _macro_cases()[name]
    kw = dict(kw, backend=backend, spec=spec)
    with tdisp.eager_programs():
        TLEDGER.reset()
        c0 = _counts()
        want = fn(*args, **kw)
        want_delta, want_acc = _delta(c0, _counts()), TLEDGER.accesses
    tdisp.clear_schedule_cache()
    for call in range(3):
        TLEDGER.reset()
        c0 = _counts()
        got = fn(*args, **kw)
        assert _same(got, want), (name, call)
        assert _delta(c0, _counts()) == want_delta, (name, call)
        assert TLEDGER.accesses == want_acc
    assert len(stand_in) == 1 and tdisp.graph_stats()["captured"] == 1
    assert tdisp.graph_stats()["replays"] == 2


def _bench_cfg(resident):
    return TArch(name="bench-decode", family="dense", n_layers=2, d_model=16,
                 n_heads=4, n_kv_heads=2, head_dim=8, d_ff=32, vocab_size=64,
                 dtype="float32", tensor_parallel=False, cim_mlp_bits=8,
                 cim_attention_bits=8, cim_unroll_groups=True,
                 cim_resident=resident)


@pytest.mark.parametrize("mode", ["streamed", "resident", "adra-sampler"])
def test_bench_decode_regions_capture_and_replay(stand_in, mode):
    """The kernel bench's decode step (188 accesses, 10 dispatches; + 8 and
    + 8 with the ADRA sampler): every region captured under the guard at
    the warm step and replayed after, logits, tokens and counts equal to
    the step's eager body."""
    from repro_torch.train import adra_sample

    model = build(_bench_cfg(mode == "resident"), device="cpu", seed=2)
    caches = model.init_caches(2, 8)
    step = {"tokens": torch.tensor([[1], [2]]),
            "positions": torch.tensor([3, 5], dtype=torch.int32)}

    def run():
        TLEDGER.reset()
        d0 = tdisp.cache_stats()["dispatches"]
        _, logits = model.decode_step(caches, step)
        tok = adra_sample(logits) if mode == "adra-sampler" else None
        return (logits, tok, TLEDGER.accesses,
                tdisp.cache_stats()["dispatches"] - d0,
                TLEDGER.load_accesses, dict(TLEDGER.per_op))

    extra = 8 if mode == "adra-sampler" else 0
    with tdisp.eager_programs():
        run()                                 # pins, as the serve's first
        want = run()
    assert want[2:4] == (188 + extra, 10 + extra)
    tdisp.clear_schedule_cache()
    for call in range(3):                     # eager, capture, replay
        got = run()
        assert torch.equal(got[0], want[0]), call
        if extra:
            assert torch.equal(got[1], want[1]), call
        assert got[2:] == want[2:], call
    # one eager call a program (its miss): a later layer's call of a
    # structurally equal region already replays in the first step
    programs = len(tdisp._PROGRAMS)
    assert tdisp.graph_stats()["captured"] == programs == len(stand_in) > 0
    assert tdisp.graph_stats()["replays"] == 3 * (10 + extra) - programs


# ---------------------------------------------------------------------------
# (b) the program's bookkeeping
# ---------------------------------------------------------------------------


def _packs(seed=5, n=70):
    rng = np.random.RandomState(seed)
    x, y = _ints(rng, -100, 100, n), _ints(rng, -100, 100, n)
    return x, y, TPack.pack(x, 8), TPack.pack(y, 8)


def test_counters_replay_on_every_call(stand_in, counting):
    """Launches and bytes (the kernel wrapper's counts) and the codec's
    packs move by the same amount at every call, eager, captured or
    replayed: the capture's counts are added back at each replay."""
    rng = np.random.RandomState(3)
    a, b = _ints(rng, -128, 128, (4, 8)), _ints(rng, -128, 128, (8, 3))
    plan = tplan.plan_matmul(8, 3)
    deltas = []
    for _ in range(4):
        c0 = _counts()
        tmacro.matmul(a, b, backend=counting)
        deltas.append(_delta(c0, _counts()))
    launches, nbytes, packs, unpacks = deltas[0][:4]
    disp, acc = deltas[0][-2:]
    assert launches == acc == plan.accesses and nbytes > 0 and packs == 2
    assert disp == 1 and unpacks == 1
    # the float kernels' launch counters (flash, RG-LRU, sLSTM) stay put;
    # N = 3 packs the lhs the expanded way
    assert deltas[0][4:10] == (0,) * 6
    assert deltas[0][10:12] == (0, 1)
    assert deltas == [deltas[0]] * 4
    assert tdisp.graph_stats() == {"captured": 1, "replays": 3, "eager": 1,
                                   "capture_s": pytest.approx(
                                       tdisp.graph_stats()["capture_s"])}


def _bump_float_kernels(x):
    """A body that counts one launch on each float kernel's wrapper, as
    the wrappers count where they launch."""
    for w in tdisp._wrappers():
        w.launches += 1
    return x + 1


def test_float_kernel_launch_counters_replay(stand_in):
    """The flash (wgmma/TMA, SIMT), RG-LRU (TMA tiles, rows) and sLSTM
    (persistent grid, rows) wrappers count in Python, which a replay does
    not run: the capture's counts are added back at each replay, so every
    call, eager, captured or replayed, moves each counter by one."""
    from repro_torch.kernels import flash_attention, rglru, slstm

    prog = tdisp.Program(_bump_float_kernels)
    x = torch.arange(4)
    names = [w.__name__ for w in tdisp._wrappers()]
    assert names == ["flash_attention_sm90", "flash_attention_simt",
                     "rglru_sm90", "rglru_rows", "slstm_sm90", "slstm_rows"]
    sums = (flash_attention.launches, rglru.launches, slstm.launches)
    for _ in range(4):
        c0, s0 = tdisp._counters(), [f() for f in sums]
        assert torch.equal(prog(x), x + 1)
        assert _delta(c0, tdisp._counters())[4:10] == (1,) * 6
        assert [f() - n for f, n in zip(sums, s0)] == [2, 2, 2]
    assert (prog.stats["eager"], prog.stats["captured"],
            prog.stats["replays"]) == (1, 1, 3)


def test_eager_first_calls_are_counted(stand_in):
    """`graph_stats()["eager"]` counts the eager first call of every
    signature on a graph device, a schedule program's recording call
    included; `compiled` reads a call that ran one or captured as not
    steady, and a replay as steady."""
    _, _, pa, pb = _packs()
    g = [tdisp.graph_stats()]
    for _ in range(3):
        tmacro.multiply(pa, pb)
        g.append(tdisp.graph_stats())
    assert [s["eager"] for s in g] == [0, 1, 1, 1]
    assert [s["captured"] for s in g] == [0, 0, 1, 1]
    assert [tdisp.compiled(a, b) for a, b in zip(g, g[1:])] == \
        [True, True, False]
    with tdisp.eager_programs():           # no graph device: not counted
        tmacro.relu(pa)
    assert tdisp.graph_stats()["eager"] == 1
    tdisp.clear_schedule_cache()
    assert tdisp.graph_stats() == {"captured": 0, "replays": 0,
                                   "capture_s": 0.0, "eager": 0}


def test_a_program_inside_a_capture_runs_its_eager_body(stand_in):
    """A program called by another program's body while that body is
    captured runs its eager body (it is part of the outer graph): no
    graph of its own, no eager first call counted."""
    inner = tdisp.Program(lambda x: x * 3)
    outer = tdisp.Program(lambda x: inner(x) + 1)
    x = torch.arange(5)
    for _ in range(3):
        assert torch.equal(outer(x), x * 3 + 1)
    assert (outer.stats["eager"], outer.stats["captured"]) == (1, 1)
    # the outer eager call was inner's first call; the capture ran it
    # eagerly inside, and replays never reach it
    assert (inner.stats["eager"], inner.stats["captured"],
            inner.stats["replays"]) == (1, 0, 0)


def test_a_pool_whose_graphs_are_gone_is_replaced(monkeypatch):
    """Graphs of a device share one pool while any of them lives; once the
    last is freed the caching allocator releases the pool, and the next
    capture takes a new one (capturing into a released pool fails)."""
    import gc

    handles = iter(range(100))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: ("pool", next(handles)))

    class Graph:
        pass
    dev = torch.device("cuda", 0)
    first, live = tdisp._pool(dev)
    g1, g2 = Graph(), Graph()
    live.add(g1)
    live.add(g2)
    assert tdisp._pool(dev)[0] == first
    del g1
    gc.collect()
    assert tdisp._pool(dev)[0] == first
    del g2
    gc.collect()
    assert tdisp._pool(dev)[0] != first


def test_dict_leaves_round_trip():
    """Leaves and results may be dicts (caches, train state, metrics):
    flattened in insertion order and rebuilt with the same keys."""
    tree_ = {"a": torch.zeros(2), "b": [{"c": torch.ones(3)}, 4],
             "d": (torch.arange(2), "e")}
    flat = []
    template = tdisp._flatten(tree_, flat)
    assert len(flat) == 3
    back = tdisp._unflatten(template, iter(flat))
    assert back.keys() == tree_.keys() and back["b"][1] == 4
    assert back["b"][0]["c"] is flat[1] and back["d"][1] == "e"


def test_successive_results_do_not_alias(stand_in):
    x, y, pa, pb = _packs()
    out = [tmacro.multiply(pa, pb) for _ in range(4)]
    ptrs = {o.planes.data_ptr() for o in out}
    assert len(ptrs) == 4
    keep = out[3].planes.clone()
    out[2].planes.zero_()
    tmacro.multiply(pa, pb)
    assert torch.equal(out[3].planes, keep)
    assert torch.equal(out[3].unpack(), x * y)


def test_new_leaf_values_give_new_results(stand_in):
    rng = np.random.RandomState(11)
    for i in range(4):      # one signature: eager, capture, replay, replay
        x, y = _ints(rng, -100, 100, 70), _ints(rng, -100, 100, 70)
        got = tmacro.multiply(TPack.pack(x, 8), TPack.pack(y, 8)).unpack()
        assert torch.equal(got, x * y), i
        a, b = _ints(rng, -128, 128, (3, 9)), _ints(rng, -128, 128, (9, 2))
        assert torch.equal(tmacro.matmul(a, b), a @ b), i
    assert tdisp.graph_stats()["captured"] == 2


def test_eviction_drops_the_graph(stand_in):
    _, _, pa, pb = _packs()
    for _ in range(2):
        tmacro.multiply(pa, pb)
    (prog,) = [p for _, p in tdisp._PROGRAMS.items()]
    assert isinstance(prog, tmacro.CompiledSchedule) and len(prog.graphs) == 1
    old = tdisp.cache_stats()["capacity"]
    try:
        tdisp.set_schedule_cache_capacity(1)
        tmacro.relu(pa)                       # evicts the multiply program
        assert tdisp.cache_stats()["evictions"] == 1
        assert prog.graphs == {}
        tmacro.relu(pa)
        (relu,) = [p for _, p in tdisp._PROGRAMS.items()]
        assert len(relu.graphs) == 1
        tdisp.clear_schedule_cache()
        assert relu.graphs == {}
    finally:
        tdisp.set_schedule_cache_capacity(old)


class _Mesh:
    """Hashable stand-in for a mesh key (unbanked programs never touch it)."""


def test_mesh_program_takes_the_graph_path(stand_in):
    """A schedule program over a mesh is captured at its second call and
    replays to the bit; its key holds the mesh by identity, so a second
    mesh gets a program and a graph of its own."""
    x, y, pa, pb = _packs()
    meshes = (_Mesh(), _Mesh())
    for mesh in meshes:
        for _ in range(3):
            got = tmacro.multiply(pa, pb, mesh=mesh).unpack()
            assert torch.equal(got, x * y)
    progs = [p for _, p in tdisp._PROGRAMS.items()]
    assert len(progs) == 2 and len(stand_in) == 2
    assert [p.mesh for p in progs] == list(meshes)
    for prog in progs:
        assert len(prog.graphs) == 1
        assert (prog.stats["eager"], prog.stats["captured"],
                prog.stats["replays"]) == (1, 1, 2)
    assert tdisp.cache_stats()["dispatches"] == 6
    assert tdisp.mesh_key(meshes[0]) != tdisp.mesh_key(meshes[1])
    assert tdisp.mesh_key(None) is None


def test_tiled_access_over_a_mesh_is_graphed_per_mesh(stand_in):
    """`execute_sharded` over a one-rank (1,) "data" mesh (a fake process
    group): eager, capture, replay, each equal to the unsharded call to the
    bit with the same ledger; an equal mesh made again (as after a new
    process group) gets a new program, not the old graph."""
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh

    _, _, pa, pb = _packs(n=200)
    TLEDGER.reset()
    want = tdisp.execute_tiled(pa, pb, ("sub", "lt"), spec=TSPEC)
    want_ledger = dataclasses.asdict(TLEDGER)
    tdisp.clear_schedule_cache()
    with fake_world(1):
        meshes = [make_mesh((1,), ("data",), "cpu") for _ in range(2)]
        assert meshes[0] == meshes[1]
        for mesh in meshes:
            for _ in range(3):
                TLEDGER.reset()
                got = tdisp.execute_sharded(pa, pb, ("sub", "lt"), mesh,
                                            spec=TSPEC)
                for op in ("sub", "lt"):
                    assert torch.equal(got[op].planes, want[op].planes)
                assert dataclasses.asdict(TLEDGER) == want_ledger
        progs = [p for _, p in tdisp._PROGRAMS.items()]
        assert [p.mesh for p in progs] == meshes
        assert all(p.stats["captured"] == 1 and p.stats["replays"] == 2
                   for p in progs)


def test_dtensor_leaves_key_on_mesh_and_placements(stand_in):
    """DTensor leaves of one global shape and dtype get one signature each
    for `Shard(0)` and `Replicate()` and for an equal mesh made again; a
    graph's static inputs are DTensors of the leaf's mesh and placements,
    and replays give the eager body's values."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh

    with fake_world(2):
        mesh, again = (make_mesh((2,), ("data",), "cpu") for _ in range(2))
        half = torch.arange(12.0).reshape(2, 6)
        shard = DTensor.from_local(half, mesh, [Shard(0)], run_check=False)
        repl = DTensor.from_local(torch.arange(24.0).reshape(4, 6), mesh,
                                  [Replicate()], run_check=False)
        shard2 = DTensor.from_local(half, again, [Shard(0)],
                                    run_check=False)
        assert shard.shape == repl.shape == shard2.shape
        sigs = {tdisp._signature([t]) for t in (shard, repl, shard2)}
        assert len(sigs) == 3
        prog = tdisp.Program(lambda t: t * 2 + 1, mesh=mesh)
        for t in (shard, repl):
            for _ in range(3):
                out = prog(t)
                assert out.placements == t.placements
                assert torch.equal(out.to_local(), t.to_local() * 2 + 1)
        assert (prog.stats["captured"], prog.stats["replays"]) == (2, 4)
        for sig, graph in prog.graphs.items():
            (static,) = graph.inputs
            assert static.device_mesh is mesh
            assert tuple(static.placements) == sig[0][3]
        assert tdisp.captures(mesh, torch.device("cpu"))
        # the fake group is not NCCL: a CUDA graph could not hold it
        assert not tdisp.captures(mesh, torch.device("cuda"))
        assert tdisp.captures(None, torch.device("cuda"))


def test_tiled_program_keeps_one_graph_per_tile_count(stand_in):
    """The standalone banked access: its program is keyed by tile shape,
    so one graph per tile count, each from its count's second call."""
    for n in (70, 200):
        x, y, pa, pb = _packs(seed=n, n=n)
        want = teng.execute(pa, pb, ("add", "lt"))
        for _ in range(3):
            got = tdisp.execute_tiled(pa, pb, ("add", "lt"), spec=TSPEC)
            for op in ("add", "lt"):
                assert torch.equal(got[op].planes, want[op].planes)
    (prog,) = [p for _, p in tdisp._PROGRAMS.items()]
    assert isinstance(prog, tdisp.Program) and len(prog.graphs) == 2
    assert tdisp.graph_stats() == dict(tdisp.graph_stats(), captured=2,
                                       replays=4)
    assert tdisp.cache_stats()["dispatches"] == 6


def _item_body(cur, a, b):
    out = cur.execute(a, b, ("add",))["add"]
    int(out.planes.sum())                 # a host read of a device value
    return out


def test_a_body_that_cannot_be_captured_raises(stand_in):
    """The warm call's capture refuses `.item()` by name, every time: there
    is no eager fallback."""
    _, _, pa, pb = _packs()
    sched = tplan.plan_elementwise(("add",), 9)
    tmacro.run_schedule_program(sched, _item_body, (pa, pb),
                                body_key=("item",))
    for _ in range(2):
        with pytest.raises(CimOpError, match="_local_scalar_dense"):
            tmacro.run_schedule_program(sched, _item_body, (pa, pb),
                                        body_key=("item",))
    with tdisp.eager_programs():
        tmacro.run_schedule_program(sched, _item_body, (pa, pb),
                                    body_key=("item",))


def _rints(rng, lo, hi, shape):
    arr = rng.randint(lo, hi, shape).astype(np.int32)
    return jnp.asarray(arr), torch.from_numpy(arr)


def _stats(disp):
    s = disp.cache_stats()
    return s["dispatches"], s["hits"], s["misses"]


def test_matmul_dispatches_like_reference(stand_in):
    """tests/test_cim_program.py:48: one dispatch a warm call, no new
    program, a hit; here over four calls (eager, capture, two replays)."""
    rng = np.random.RandomState(5)
    ra, ta = _rints(rng, -128, 128, (8, 16))
    rb, tb = _rints(rng, -128, 128, (16, 4))
    want = np.asarray(ra, np.int64) @ np.asarray(rb, np.int64)
    for _ in range(4):
        r0, t0 = _stats(rdisp), _stats(tdisp)
        rc = rcim.matmul(ra, rb, n_bits=8, backend="jnp-boolean")
        tc = tcim.matmul(ta, tb, n_bits=8, backend="torch-boolean")
        assert _delta(t0, _stats(tdisp)) == _delta(r0, _stats(rdisp))
        np.testing.assert_array_equal(np.asarray(rc), want)
        np.testing.assert_array_equal(tc.numpy(), want)
    assert tdisp.graph_stats()["captured"] == 1


def _ledger(led):
    out = {}
    for f in dataclasses.fields(led):
        if f.name != "enabled":
            v = getattr(led, f.name)
            out[f.name] = dict(v) if isinstance(v, dict) else v
    return out


def test_warm_ledger_equals_cold_like_reference(stand_in):
    """tests/test_cim_program.py:63: every warm call's ledger equals the
    cold one's, field for field, and equals the reference's."""
    rng = np.random.RandomState(5)
    rx, tx = _rints(rng, -100, 100, 66)
    ry, ty = _rints(rng, -100, 100, 66)
    rpa, rpb = RPack.pack(rx, 8), RPack.pack(ry, 8)
    tpa, tpb = TPack.pack(tx, 8), TPack.pack(ty, 8)
    RLEDGER.reset()
    rcold = rmacro.multiply(rpa, rpb, backend="jnp-boolean")
    rled = _ledger(RLEDGER)
    for _ in range(3):
        TLEDGER.reset()
        got = tmacro.multiply(tpa, tpb, backend="torch-boolean")
        tled = _ledger(TLEDGER)
        for k in ("accesses", "words32", "per_op", "load_accesses"):
            assert tled[k] == rled[k], k
        np.testing.assert_array_equal(got.unpack().numpy(),
                                      np.asarray(rcold.unpack()))


def test_charges_replay_like_reference(stand_in):
    """tests/test_cim_program.py:76: three popcounts charge three plans."""
    rng = np.random.RandomState(5)
    rx, tx = _rints(rng, -100, 100, 48)
    RLEDGER.reset()
    TLEDGER.reset()
    for _ in range(3):
        rmacro.popcount(RPack.pack(rx, 8), backend="jnp-boolean")
        tmacro.popcount(TPack.pack(tx, 8), backend="torch-boolean")
    assert TLEDGER.accesses == RLEDGER.accesses \
        == 3 * rplan.plan_popcount(8).accesses
    assert tdisp.graph_stats()["replays"] == 2


# ---------------------------------------------------------------------------
# the port's public surface against the reference's
# ---------------------------------------------------------------------------

#: reference names the port leaves out, with the reason
DEPARTURES = {
    # the TPU probe: the port runs on CUDA or on a plain device
    ("cim", "on_tpu"): "no TPU",
    # the Pallas kernel's lane block; the CUDA kernel takes any width
    ("cim", "DEFAULT_BLOCK_W"): "no Pallas block",
}


def _public_names(path: Path):
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return [n for n in names if n != "*" and not n.startswith("_")]


PACKAGES = sorted(p.parent.name for p in
                  (ROOT / "src" / "repro").glob("*/__init__.py"))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_reference_public_names_resolve_in_the_port(pkg):
    """`kernels`' rglru, slstm and flash_attention resolve to the port's
    modules (route and launch counters), not the reference's functions
    (`src/repro_torch/kernels/__init__.py`)."""
    import importlib

    port = importlib.import_module(f"repro_torch.{pkg}")
    names = _public_names(ROOT / "src" / "repro" / pkg / "__init__.py")
    assert names
    missing = [n for n in names if not hasattr(port, n)
               and (pkg, n) not in DEPARTURES]
    assert missing == []
    for (p, n) in DEPARTURES:
        if p == pkg:
            assert n in names and not hasattr(port, n)


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_stack_layout_equals_reference(arch):
    t = tmodel.StackLayout.from_config(treg.get_config(arch))
    r = rmodel.StackLayout.from_config(rreg.get_config(arch))
    assert dataclasses.asdict(t) == dataclasses.asdict(r)


def test_cost_main_prints_the_wins_table(capsys):
    """`python -m repro_torch.cim.cost` prints the table, as the
    reference's module does."""
    from repro_torch.cim import cost as tcost

    with warnings.catch_warnings():     # runpy: the package imported it
        warnings.simplefilter("ignore", RuntimeWarning)
        runpy.run_module("repro_torch.cim.cost", run_name="__main__")
    assert capsys.readouterr().out.strip() == tcost.cim_wins_table().strip()
