"""Port vs reference: the banked CiM array.

The same seeded inputs go through the reference (`jnp-boolean` backend)
and the port's plain version: tiled results must be bit-exact and every
ledger field equal (word counts within 1e-12 relative), as must every
`bank_report` field. The contracts mirror the reference's own tests of the
array (tests/test_cim_array.py), of schedule programs
(tests/test_cim_program.py) and of macros (tests/test_cim_macro.py), plus
degraded specs, the spec override, the cache-capacity variable, the
65535-tile launch split and the slice end to end: `mlp_cim` and `sdpa_cim`
of reduced gemma-2b on a banked spec against the reference's lowered ones.
"""
import dataclasses

import jax
import jax.extend.core as jex
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cim import array as rarray
from repro.cim import dispatch as rdisp
from repro.cim import macro as rmacro
from repro.cim import planner as rplan
from repro.cim.accounting import LEDGER as RLEDGER
from repro.cim.accounting import Ledger as RLedger
from repro.cim.opset import CimOpError as RCimOpError
from repro.cim.planepack import PlanePack as RPack
from repro.models import attention as rattn
from repro.models import layers as rlayers
from repro_torch.cim import array as tarray
from repro_torch.cim import dispatch as tdisp
from repro_torch.cim import engine as teng
from repro_torch.cim import fused_kernel as tfk
from repro_torch.cim import macro as tmacro
from repro_torch.cim import planner as tplan
from repro_torch.cim.accounting import LEDGER as TLEDGER
from repro_torch.cim.accounting import Ledger as TLedger
from repro_torch.cim.opset import CimOpError
from repro_torch.cim.planepack import PlanePack as TPack
from repro_torch.configs import preset_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

_RB = "jnp-boolean"           # the reference's plain backend
OPS = ("sub", "lt", "eq", "xor")
#: the slice's banked array: 32-word tiles, so reduced shapes span banks
SPEC = dict(banks=4, subarrays=1, rows=256, bitline_words=32)
#: float tolerance against the reference's float ops (quantize, rescale,
#: GELU, softmax): the integer contractions are exact on both sides
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _specs(**kw):
    return rarray.ArraySpec(**kw), tarray.ArraySpec(**kw)


def _reset():
    for clear in (TLEDGER.reset, RLEDGER.reset, tarray.clear_resident,
                  rarray.clear_resident, tdisp.clear_schedule_cache,
                  rdisp.clear_schedule_cache):
        clear()
    tarray.set_current_spec(None)
    rarray.set_current_spec(None)


@pytest.fixture(autouse=True)
def _fresh_state():
    _reset()
    yield
    _reset()


@pytest.fixture
def ref_lowering(monkeypatch):
    """The reference's lowering under JAX 0.9, for this test only."""
    monkeypatch.setattr(jax.core, "Literal", jex.Literal, raising=False)
    monkeypatch.setattr(jax.core, "Var", jex.Var, raising=False)
    yield
    rlayers._LOWERED_MLP.clear()
    rlayers._LOWERED_LINEAR.clear()
    rattn._LOWERED_SDPA.clear()


def _fields(led):
    return {f.name: (dict(getattr(led, f.name))
                     if isinstance(getattr(led, f.name), dict)
                     else getattr(led, f.name))
            for f in dataclasses.fields(led) if f.name != "enabled"}


def _same(r: dict, t: dict) -> None:
    """Equal dicts; floats within 1e-12 relative."""
    assert r.keys() == t.keys()
    for k in r:
        if isinstance(r[k], float):
            assert t[k] == pytest.approx(r[k], rel=1e-12, abs=0), k
        else:
            assert t[k] == r[k], k


def _same_ledger(rspec=None, tspec=None) -> None:
    _same(_fields(RLEDGER), _fields(TLEDGER))
    assert TLEDGER.per_device() == RLEDGER.per_device()
    if rspec is not None:
        _same(RLEDGER.bank_report(rspec), TLEDGER.bank_report(tspec))


def _ints(seed, n_bits, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(-(1 << (n_bits - 1)), 1 << (n_bits - 1),
                        shape).astype(np.int32)


def _packs(x, n_bits, signed=True):
    return (RPack.pack(jnp.asarray(x), n_bits, signed=signed),
            TPack.pack(torch.from_numpy(np.asarray(x)), n_bits, signed=signed))


def _eq(t_pack, r_pack):
    assert t_pack.n_bits == r_pack.n_bits and t_pack.signed == r_pack.signed
    assert tuple(t_pack.shape) == tuple(r_pack.shape)
    np.testing.assert_array_equal(t_pack.planes.numpy().view(np.uint32),
                                  np.asarray(r_pack.planes))


# ---------------------------------------------------------------------------
# geometry: specs, plans, placement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(banks=0), dict(bitline_words=31), dict(bitline_words=0),
    dict(rows=0), dict(banks=2, disabled_banks=(2,)),
    dict(banks=2, disabled_banks=(0, 1)), dict(disabled_banks=(-1,))])
def test_spec_validation_errors(kw):
    with pytest.raises(CimOpError):
        tarray.ArraySpec(**kw)
    with pytest.raises(RCimOpError):
        rarray.ArraySpec(**kw)


def test_spec_properties_and_healthy_identity():
    with pytest.raises(CimOpError):
        tarray.ArraySpec().plan(0)
    healthy = tarray.ArraySpec()
    assert healthy == tarray.DEFAULT_SPEC and hash(healthy) == \
        hash(tarray.ArraySpec(4, 4, 1024, 1024, ()))
    assert healthy.plan(5000).enabled == ()
    for kw in (dict(), dict(banks=5, subarrays=2, bitline_words=64),
               dict(banks=4, disabled_banks=(3, 1, 1))):
        r, t = _specs(**kw)
        for spec in ((r, t), (r.disable_bank(2), t.disable_bank(2))):
            rs, ts = spec
            assert ts.disabled_banks == rs.disabled_banks
            assert ts.enabled_banks == rs.enabled_banks
            assert (ts.n_enabled, ts.tile_words, ts.parallel_words) == \
                (rs.n_enabled, rs.tile_words, rs.parallel_words)
    r, t = _specs(banks=2)
    with pytest.raises(CimOpError):
        t.disable_bank(0).disable_bank(1)
    assert t.disable_bank(1) != t and hash(t.disable_bank(1)) != hash(t)


@pytest.mark.parametrize("n_words", [1, 31, 32, 33, 4096, 5 * 4096 + 7])
@pytest.mark.parametrize("kw", [dict(banks=3, subarrays=1, bitline_words=32),
                                dict(banks=4, disabled_banks=(1,)),
                                dict(banks=5, subarrays=2, bitline_words=64,
                                     disabled_banks=(0, 4))])
def test_tile_plans_match_reference(n_words, kw):
    r, t = (s.plan(n_words) for s in _specs(**kw))
    for f in ("n_words", "tile_words", "n_tiles", "banks", "enabled",
              "live_banks", "n_live", "lanes_per_tile", "waves",
              "pad_words"):
        assert getattr(t, f) == getattr(r, f), f
    assert [t.bank_of(i) for i in range(t.n_tiles)] == \
        [r.bank_of(i) for i in range(r.n_tiles)]
    for n_dev in (1, 2, 3):
        assert t.bank_counts(n_dev) == r.bank_counts(n_dev)


def test_rows_budget_with_resident_rows():
    r, t = _specs(banks=1, subarrays=1, rows=32, bitline_words=32)
    t.check_fits(8, ("add",))                    # 16 + 9 rows
    with pytest.raises(CimOpError, match="held by resident"):
        t.check_fits(8, ("add",), resident_rows=8)
    with pytest.raises(RCimOpError, match="held by resident"):
        r.check_fits(8, ("add",), resident_rows=8)
    (ra, ta) = _packs(_ints(3, 8, 10), 8)
    tight = tarray.ArraySpec(banks=1, subarrays=1, rows=16, bitline_words=32)
    with pytest.raises(CimOpError):              # 2*8 operand + 9 out > 16
        tdisp.execute_tiled(ta, ta, ("add",), spec=tight)
    tdisp.execute_tiled(ta, ta, ("add",), spec=t)
    # rows pinned in the registry set of a geometry squeeze its accesses
    rs = tarray.resident_set(t)
    rs.reserve(("kv", 0), 8, bank=0)
    assert tarray.resident_rows_for(t) == 8
    with pytest.raises(CimOpError, match="held by resident"):
        tdisp.execute_tiled(ta, ta, ("add",), spec=t)


# ---------------------------------------------------------------------------
# the tiled dispatcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_bits,n_words,banks,subarrays", [
    (2, 1, 1, 1), (5, 33, 2, 1), (8, 100, 3, 1), (12, 300, 5, 3),
    (7, 257, 4, 2), (3, 64, 1, 2)])
def test_tiling_round_trip_matches_reference_and_untiled(n_bits, n_words,
                                                         banks, subarrays):
    x, y = _ints(n_words, n_bits, n_words), _ints(n_bits, n_bits, n_words)
    (ra, ta), (rb, tb) = _packs(x, n_bits), _packs(y, n_bits)
    rspec, tspec = _specs(banks=banks, subarrays=subarrays, rows=128,
                          bitline_words=32)
    tout = tdisp.execute_tiled(ta, tb, OPS, spec=tspec)
    rout = rdisp.execute_tiled(ra, rb, OPS, spec=rspec, backend=_RB)
    n_tiles = -(-n_words // tspec.tile_words)
    assert TLEDGER.accesses == n_tiles
    assert max(TLEDGER.bank_accesses.values()) == -(-n_tiles // banks)
    _same_ledger(rspec, tspec)
    flat = teng.execute(ta, tb, OPS)
    for op in OPS:
        _eq(tout[op], rout[op])
        assert torch.equal(tout[op].planes, flat[op].planes)


def test_multidim_operands_tile_exactly():
    x, y = _ints(11, 8, (2, 13, 5)), _ints(12, 8, (2, 13, 5))
    (ra, ta), (rb, tb) = _packs(x, 8), _packs(y, 8)
    rspec, tspec = _specs(banks=3, subarrays=1, rows=128, bitline_words=32)
    out = tdisp.execute_tiled(ta, tb, ("add",), spec=tspec)
    _eq(out["add"], rdisp.execute_tiled(ra, rb, ("add",), spec=rspec,
                                        backend=_RB)["add"])
    np.testing.assert_array_equal(out["add"].unpack().numpy(), x + y)
    _same_ledger(rspec, tspec)


def test_mesh_is_refused():
    """A mesh without the requested axis raises CimOpError (the reference's
    `test_mesh_axis_validated_at_dispatch`)."""
    ta = TPack.pack(torch.arange(10), 8)
    with pytest.raises(CimOpError, match="no 'data'"):
        tdisp.execute_tiled(ta, ta, ("add",), mesh=object())


def test_tiled_access_beyond_one_launch_of_tiles():
    """More tiles than one kernel launch covers (65535): the plain path
    takes the whole stack, equal to the untiled access."""
    spec = tarray.ArraySpec(banks=4, subarrays=1, rows=64, bitline_words=32)
    n = 32 * 65537 - 5
    x = torch.from_numpy(_ints(31, 2, n))
    pa = TPack.pack(x, 2)
    pb = TPack.pack(torch.flip(x, (0,)), 2)
    out = tdisp.execute_tiled(pa, pb, ("sub", "xor"), spec=spec)
    flat = teng.execute(pa, pb, ("sub", "xor"))
    for op in ("sub", "xor"):
        assert torch.equal(out[op].planes, flat[op].planes)
    assert TLEDGER.accesses == 65537 + 1
    gen = torch.Generator().manual_seed(0)
    a, b = (torch.randint(-2 ** 31, 2 ** 31, (65537, 2, 4), dtype=torch.int32,
                          generator=gen) for _ in range(2))
    tiles = tfk.fused_planes_op(a, b, ("add", "gt"))
    flat = tfk.fused_planes_op(a.transpose(0, 1).reshape(2, -1),
                               b.transpose(0, 1).reshape(2, -1), ("add", "gt"))
    for t, f in zip(tiles, flat):
        assert torch.equal(t.transpose(0, 1).reshape(f.shape), f)


@pytest.mark.cuda
def test_kernel_splits_long_tile_axes_and_counts_truthfully():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    t = tfk.MAX_TILES_PER_LAUNCH + 3
    a = torch.randint(-2 ** 31, 2 ** 31, (t, 3, 8), dtype=torch.int32,
                      device="cuda")
    b = torch.randint(-2 ** 31, 2 ** 31, (t, 3, 8), dtype=torch.int32,
                      device="cuda")
    launches, moved = tfk.fused_planes_op.launches, tfk.fused_planes_op.bytes
    got = tfk.fused_planes_op(a, b, ("add", "lt"))
    assert tfk.fused_planes_op.launches - launches == 2
    assert tfk.fused_planes_op.bytes - moved == (2 * 3 + 4 + 1) * 8 * 4 * t
    for g, r in zip(got, tfk.fused_planes_op_ref(a, b, ("add", "lt"))):
        assert torch.equal(g, r)


# ---------------------------------------------------------------------------
# the ledger and the bank report
# ---------------------------------------------------------------------------


def test_ledger_reset_clears_every_field_and_disabled_charges_nothing():
    for cls in (TLedger, RLedger):
        spec = (tarray if cls is TLedger else rarray).ArraySpec(
            banks=2, subarrays=1, rows=64, bitline_words=32)
        led = cls()
        led.charge(("sub", "lt"), 8, 100)
        led.charge_banked(("add",), 8, 100, spec.plan(100))
        led.charge_reduction(12.5)
        assert led.accesses and led.per_op and led.bank_accesses
        assert led.activated_words32 and led.inter_bank_words32
        led.reset()
        assert dataclasses.asdict(led) == dataclasses.asdict(cls())
        assert led.per_op == {} and led.bank_accesses == {}
        off = cls(enabled=False)
        off.charge(("sub",), 8, 10)
        off.charge_banked(("add",), 8, 10, spec.plan(10))
        off.charge_reduction(5.0)
        assert dataclasses.asdict(off) == \
            dataclasses.asdict(cls(enabled=False))


def test_bank_report_contention_and_utilization():
    rspec, tspec = _specs(banks=4, subarrays=1, rows=128, bitline_words=32)
    (ra, ta), (rb, tb) = _packs(_ints(5, 8, 160), 8), _packs(_ints(6, 8, 160), 8)
    tdisp.execute_tiled(ta, tb, ("add",), spec=tspec)
    rdisp.execute_tiled(ra, rb, ("add",), spec=rspec, backend=_RB)
    rep = TLEDGER.bank_report(tspec)
    assert rep["activations"] == 5 and rep["waves"] == 2
    assert rep["ideal_waves"] == 2
    assert rep["utilization"] == pytest.approx(1.0)
    assert 0 < rep["edp_decrease_pct"] < 100
    assert rep["cim_edp"] < rep["baseline_edp"]
    _same_ledger(rspec, tspec)
    for scheme in ("scheme1", "scheme2"):
        _same(RLEDGER.bank_report(rspec, scheme=scheme, rows=512),
              TLEDGER.bank_report(tspec, scheme=scheme, rows=512))
    TLEDGER.reset()
    RLEDGER.reset()
    _same(RLEDGER.bank_report(rspec), TLEDGER.bank_report(tspec))


# ---------------------------------------------------------------------------
# the program cache
# ---------------------------------------------------------------------------


def test_schedule_cache_hits_misses_and_keys():
    ta = TPack.pack(torch.from_numpy(_ints(9, 8, 100)), 8)
    spec = tarray.ArraySpec(banks=2, subarrays=1, rows=128, bitline_words=32)

    def stats():
        s = tdisp.cache_stats()
        return {k: s[k] for k in ("hits", "misses", "entries", "dispatches")}

    tdisp.execute_tiled(ta, ta, ("add",), spec=spec)
    assert stats() == {"hits": 0, "misses": 1, "entries": 1, "dispatches": 1}
    tdisp.execute_tiled(ta, ta, ("add",), spec=spec)
    assert stats() == {"hits": 1, "misses": 1, "entries": 1, "dispatches": 2}
    # the bank count is not part of the key (same tile shape)...
    tdisp.execute_tiled(ta, ta, ("add",), spec=dataclasses.replace(
        spec, banks=4))
    assert tdisp.cache_stats()["hits"] == 2
    # ...but ops, tile shape and backend are
    tdisp.execute_tiled(ta, ta, ("sub",), spec=spec)
    tdisp.execute_tiled(ta, ta, ("add",),
                        spec=dataclasses.replace(spec, subarrays=2))
    tdisp.execute_tiled(ta, ta, ("add",), spec=spec, backend="torch-boolean")
    s = tdisp.cache_stats()
    assert s["misses"] == 4 and s["entries"] == 4


def test_schedule_cache_lru_bound_and_evictions():
    ta = TPack.pack(torch.from_numpy(_ints(9, 8, 100)), 8)
    spec = tarray.ArraySpec(banks=2, subarrays=1, rows=128, bitline_words=32)
    old = tdisp.cache_stats()["capacity"]
    try:
        tdisp.set_schedule_cache_capacity(2)

        def run(ops):
            tdisp.execute_tiled(ta, ta, ops, spec=spec)

        run(("add",))
        run(("sub",))
        run(("xor",))                       # evicts add
        s = tdisp.cache_stats()
        assert s["entries"] == 2 and s["evictions"] == 1
        run(("add",))
        s = tdisp.cache_stats()
        assert s["misses"] == 4 and s["evictions"] == 2
        run(("xor",))                       # a hit refreshes xor
        assert tdisp.cache_stats()["hits"] == 1
        run(("or",))                        # evicts add, the coldest
        run(("xor",))
        s = tdisp.cache_stats()
        assert s["hits"] == 2 and s["entries"] == 2 and s["evictions"] == 3
        tdisp.set_schedule_cache_capacity(1)
        assert tdisp.cache_stats()["entries"] == 1
        assert len(tdisp._PROGRAMS) == 1
        with pytest.raises(CimOpError):
            tdisp.set_schedule_cache_capacity(0)
    finally:
        tdisp.set_schedule_cache_capacity(old)
    lru = tdisp.BoundedLRU(3)
    lru.put("k", 1)
    assert "k" in lru and "j" not in lru and len(lru) == 1


@pytest.mark.parametrize("raw,want", [(None, 256), ("7", 7), ("0", 256),
                                      ("-3", 256), ("many", 256)])
def test_cache_capacity_variable_matches_reference(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv("REPRO_CIM_CACHE_CAPACITY", raising=False)
    else:
        monkeypatch.setenv("REPRO_CIM_CACHE_CAPACITY", raw)
    assert tdisp._env_capacity() == rdisp._env_capacity() == want


# ---------------------------------------------------------------------------
# banked macros: one dispatch, charges replayed, every macro its plan
# ---------------------------------------------------------------------------


_SMALL = dict(banks=2, subarrays=1, rows=256, bitline_words=32)


def _macro_cases(spec_r, spec_t, n_bits=8, n=70, seed=13):
    x, y = _ints(seed, n_bits, n), _ints(seed + 1, n_bits, n)
    (ra, ta), (rb, tb) = _packs(x, n_bits), _packs(y, n_bits)
    return [
        ("multiply", lambda: rmacro.multiply(ra, rb, _RB, spec=spec_r),
         lambda: tmacro.multiply(ta, tb, spec=spec_t),
         tplan.plan_multiply(n_bits, n_bits), x * y),
        ("abs", lambda: rmacro.abs_(ra, _RB, spec=spec_r),
         lambda: tmacro.abs_(ta, spec=spec_t), tplan.plan_abs(n_bits),
         np.abs(x)),
        ("relu", lambda: rmacro.relu(ra, _RB, spec=spec_r),
         lambda: tmacro.relu(ta, spec=spec_t), tplan.plan_relu(n_bits),
         np.maximum(x, 0)),
        ("minimum", lambda: rmacro.minimum(ra, rb, _RB, spec=spec_r),
         lambda: tmacro.minimum(ta, tb, spec=spec_t),
         tplan.plan_minimum(n_bits), np.minimum(x, y)),
        ("maximum", lambda: rmacro.maximum(ra, rb, _RB, spec=spec_r),
         lambda: tmacro.maximum(ta, tb, spec=spec_t),
         tplan.plan_maximum(n_bits), np.maximum(x, y)),
        ("popcount", lambda: rmacro.popcount(ra, _RB, spec=spec_r),
         lambda: tmacro.popcount(ta, spec=spec_t),
         tplan.plan_popcount(n_bits),
         np.array([bin(int(v) & (1 << n_bits) - 1).count("1") for v in x])),
        ("reduce_sum", lambda: rmacro.reduce_sum(ra, _RB, spec=spec_r),
         lambda: tmacro.reduce_sum(ta, spec=spec_t),
         tplan.plan_reduce_sum(n, n_bits=n_bits), x.sum()),
    ]


@pytest.mark.parametrize("banked", [False, True], ids=["unbanked", "banked"])
def test_every_macro_charges_exactly_its_plan_like_the_reference(banked):
    rspec, tspec = _specs(**_SMALL) if banked else (None, None)
    for name, rfn, tfn, plan, want in _macro_cases(rspec, tspec):
        if banked:
            plan = plan.placed(tspec, 70)
        TLEDGER.reset()
        RLEDGER.reset()
        t, r = tfn(), rfn()
        _eq(t, r)
        np.testing.assert_array_equal(t.unpack().numpy(), want)
        assert TLEDGER.accesses == plan.placed_accesses, name
        _same_ledger(rspec, tspec)


def test_warm_banked_macro_is_one_dispatch_and_replays_its_charges():
    rspec, tspec = _specs(**_SMALL)
    for name, rfn, tfn, plan, _ in _macro_cases(rspec, tspec, seed=40):
        placed = plan.placed(tspec, 70)
        tfn()
        rfn()
        before = tdisp.cache_stats()
        r_before = rdisp.cache_stats()
        TLEDGER.reset()
        RLEDGER.reset()
        tfn()
        rfn()
        after, r_after = tdisp.cache_stats(), rdisp.cache_stats()
        for c in ("dispatches", "misses", "hits"):
            assert after[c] - before[c] == r_after[c] - r_before[c], (name, c)
        assert after["dispatches"] - before["dispatches"] == 1, name
        assert after["misses"] == before["misses"], name
        assert TLEDGER.accesses == placed.placed_accesses, name
        _same_ledger(rspec, tspec)


@pytest.mark.parametrize("banked", [False, True], ids=["unbanked", "banked"])
def test_program_ledger_equals_eager_cursor(banked):
    rspec, tspec = _specs(**_SMALL) if banked else (None, None)
    x, y = _ints(50, 8, 70), _ints(51, 8, 70)
    (ra, ta), (rb, tb) = _packs(x, 8), _packs(y, 8)
    for body, args_t, args_r, plan in (
            (tmacro._multiply_with, (ta, tb), (ra, rb),
             tplan.plan_multiply(8, 8)),
            (tmacro._reduce_sum_body, (ta,), (ra,),
             tplan.plan_reduce_sum(70, n_bits=8))):
        if banked:
            plan = plan.placed(tspec, 70)
        TLEDGER.reset()
        cur = tmacro.ScheduleCursor(plan, spec=tspec)
        eager = body(cur, *args_t)
        cur.finish()
        eager_led = _fields(TLEDGER)
        rplan_ = getattr(rplan, "plan_multiply")(8, 8) \
            if body is tmacro._multiply_with \
            else rplan.plan_reduce_sum(70, n_bits=8)
        if banked:
            rplan_ = rplan_.placed(rspec, 70)
        RLEDGER.reset()
        rcur = rmacro.ScheduleCursor(rplan_, _RB, spec=rspec)
        ref = getattr(rmacro, body.__name__)(rcur, *args_r)
        rcur.finish()
        _same_ledger(rspec, tspec)
        _eq(eager, ref)
        TLEDGER.reset()
        fn = tmacro.multiply if body is tmacro._multiply_with \
            else tmacro.reduce_sum
        out = fn(*args_t, spec=tspec)
        assert _fields(TLEDGER) == eager_led
        assert torch.equal(out.planes, eager.planes)
        if banked and body is tmacro._reduce_sum_body:
            assert TLEDGER.inter_bank_words32 > 0


def test_banked_matmul_inter_bank_reduction_and_resident_rhs():
    rspec, tspec = _specs(**_SMALL)
    rng = np.random.default_rng(17)
    a = rng.integers(-8, 8, (4, 7)).astype(np.int32)
    b = rng.integers(-8, 8, (7, 3)).astype(np.int32)
    t = tmacro.matmul(torch.from_numpy(a), torch.from_numpy(b), n_bits=4,
                      spec=tspec)
    r = rmacro.matmul(jnp.asarray(a), jnp.asarray(b), n_bits=4, backend=_RB,
                      spec=rspec)
    np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    np.testing.assert_array_equal(t.numpy(), a.astype(np.int64) @ b)
    placed = tplan.plan_matmul(7, 3, n_bits=4).placed(tspec, 4 * 8 * 3)
    assert TLEDGER.accesses == placed.placed_accesses
    assert TLEDGER.inter_bank_words32 > 0
    _same_ledger(rspec, tspec)
    tp = tmacro.matmul_rhs_pack(torch.from_numpy(b), 4, 4)
    rp = rmacro.matmul_rhs_pack(jnp.asarray(b), 4, 4)
    t2 = tmacro.matmul(torch.from_numpy(a), n_bits=4, spec=tspec, b_pack=tp)
    r2 = rmacro.matmul(jnp.asarray(a), n_bits=4, backend=_RB, spec=rspec,
                       b_pack=rp)
    np.testing.assert_array_equal(t2.numpy(), np.asarray(r2))
    a3 = rng.integers(-127, 128, (2, 3, 5, 9)).astype(np.int32)
    b3 = rng.integers(-127, 128, (2, 3, 9, 6)).astype(np.int32)
    t3 = tmacro.batched_matmul(torch.from_numpy(a3), torch.from_numpy(b3),
                               spec=tspec)
    r3 = rmacro.batched_matmul(jnp.asarray(a3), jnp.asarray(b3), backend=_RB,
                               spec=rspec)
    np.testing.assert_array_equal(t3.numpy(), np.asarray(r3))
    RLEDGER.reset()
    TLEDGER.reset()
    k = rng.integers(-127, 128, 21).astype(np.int32)
    assert int(tmacro.dot(torch.from_numpy(k), torch.from_numpy(k[::-1].copy()),
                          spec=tspec)) == \
        int(rmacro.dot(jnp.asarray(k), jnp.asarray(k[::-1].copy()),
                       backend=_RB, spec=rspec))
    _same_ledger(rspec, tspec)


@pytest.mark.parametrize("banked", [False, True], ids=["unbanked", "banked"])
def test_chain_executor_runs_a_region_like_the_reference(banked):
    rspec, tspec = _specs(**_SMALL) if banked else (None, None)
    x, y = _ints(60, 8, (6, 7)), _ints(61, 8, (6, 7))
    (ra, ta), (rb, tb) = _packs(x, 8), _packs(y, 8)
    ma = _ints(62, 8, (3, 5))
    mb = _ints(63, 8, (5, 4))
    parts = ("plan_minimum", (8,)), ("plan_multiply", (8, 8)), \
        ("plan_abs", (16,)), ("plan_neg", (17,)), \
        ("plan_popcount", (8,)), ("plan_reduce_sum", (42,)), \
        ("plan_matmul", (5, 4))
    outs = {}
    for side, pl, mod, spec, a, b, led in (
            ("t", tplan, tmacro, tspec, ta, tb, TLEDGER),
            ("r", rplan, rmacro, rspec, ra, rb, RLEDGER)):
        region = pl.concat_schedules([getattr(pl, p)(*args)
                                      for p, args in parts])
        if spec is not None:
            region = region.placed(spec, 42)
        kw = {} if side == "t" else {"backend": _RB}
        chain = mod.ChainExecutor(region, spec=spec, **kw)
        lo = chain.minimum(a, b)
        prod = chain.multiply(lo, b)
        ab = chain.abs_(prod)
        neg = chain.neg(ab)
        pop = chain.popcount(a)
        tot = chain.reduce_sum(a)
        conv = torch.from_numpy if side == "t" else jnp.asarray
        mm = chain.matmul(conv(ma), conv(mb), 8)
        chain.finish()
        outs[side] = (lo, prod, ab, neg, pop, tot, mm)
    for t, r in zip(outs["t"], outs["r"]):
        _eq(t, r)
    np.testing.assert_array_equal(outs["t"][3].unpack().numpy(),
                                  -np.abs(np.minimum(x, y) * y))
    np.testing.assert_array_equal(outs["t"][6].unpack().numpy(),
                                  ma.astype(np.int64) @ mb)
    _same_ledger(rspec, tspec)


def test_chain_executor_from_a_program_cursor_is_one_dispatch():
    tspec = tarray.ArraySpec(**_SMALL)
    x, y = _ints(70, 8, 40), _ints(71, 8, 40)
    ta, tb = TPack.pack(torch.from_numpy(x), 8), \
        TPack.pack(torch.from_numpy(y), 8)
    region = tplan.concat_schedules([tplan.plan_maximum(8),
                                     tplan.plan_relu(8)]).placed(tspec, 40)

    def body(cur, a, b):
        chain = tmacro.ChainExecutor.from_cursor(cur)
        return tmacro._relu_with(chain.cursor, chain.maximum(a, b))

    for _ in range(2):
        before = tdisp.cache_stats()["dispatches"]
        TLEDGER.reset()
        out = tmacro.run_schedule_program(region, body, (ta, tb),
                                          body_key=("max-relu",), spec=tspec)
        assert tdisp.cache_stats()["dispatches"] - before == 1
        assert TLEDGER.accesses == region.placed_accesses == 2 * 2
    np.testing.assert_array_equal(out.unpack().numpy(),
                                  np.maximum(np.maximum(x, y), 0))


# ---------------------------------------------------------------------------
# degraded specs and the spec override
# ---------------------------------------------------------------------------


def test_degraded_spec_never_charges_the_dead_bank():
    rspec, tspec = (s.disable_bank(1) for s in _specs(**SPEC))
    x, y = _ints(80, 8, 300), _ints(81, 8, 300)
    (ra, ta), (rb, tb) = _packs(x, 8), _packs(y, 8)
    healthy = tmacro.multiply(ta, tb, spec=tarray.ArraySpec(**SPEC))
    TLEDGER.reset()
    t = tmacro.multiply(ta, tb, spec=tspec)
    r = rmacro.multiply(ra, rb, _RB, spec=rspec)
    _eq(t, r)
    assert torch.equal(t.planes, healthy.planes)
    assert all(bank != 1 for _dev, bank in TLEDGER.bank_accesses)
    assert TLEDGER.accesses == \
        tplan.plan_multiply(8, 8).placed(tspec, 300).placed_accesses
    _same_ledger(rspec, tspec)


def test_current_spec_and_override_resolution():
    tspec = tarray.ArraySpec(**SPEC).disable_bank(2)
    assert tarray.current_spec() == tarray.DEFAULT_SPEC
    assert tarray.spec_override() is None
    assert tarray.set_current_spec(tspec) is None
    assert tarray.current_spec() == tarray.spec_override() == tspec
    assert tarray.resident_set() is tarray.resident_set(tspec)
    assert tarray.set_current_spec(None) == tspec
    assert tarray.current_spec() == tarray.DEFAULT_SPEC


def _mlp_inputs(seed=0, tokens=2):
    rcfg = preset_config("gemma-2b", "reduced")
    rp = jax.tree.map(np.asarray, rlayers.mlp_init(
        jax.random.PRNGKey(seed + 1), rcfg.d_model, rcfg.d_ff, rcfg.gating,
        jnp.float32))
    x = np.random.default_rng(seed).normal(
        size=(tokens, 1, rcfg.d_model)).astype(np.float32)
    tp = {k: torch.from_numpy(v.copy()) for k, v in rp.items()}
    return ({k: jnp.asarray(v) for k, v in rp.items()}, jnp.asarray(x),
            tp, torch.from_numpy(x), rcfg.gating)


def test_mlp_cim_spec_matches_reference_banked_and_under_override(
        ref_lowering):
    """`spec=S` banks the MLP's contractions; `spec=None` follows
    `set_current_spec(S)`: the same outputs and ledgers as the reference's
    lowered MLP, a degraded S charging no dead bank."""
    rp, rx, tp, tx, gating = _mlp_inputs()
    rspec, tspec = (s.disable_bank(3) for s in _specs(**SPEC))
    twin = tlayers._mlp_quantized(tp, tx, gating, 8)
    unbanked = tlayers.mlp_cim(tp, tx, gating)
    assert torch.equal(unbanked, twin)
    for install in (False, True):
        _reset()
        if install:
            tarray.set_current_spec(tspec)
            rarray.set_current_spec(rspec)
            t = tlayers.mlp_cim(tp, tx, gating)
            r = rlayers.mlp_cim(rp, rx, gating)
        else:
            t = tlayers.mlp_cim(tp, tx, gating, spec=tspec)
            r = rlayers.mlp_cim(rp, rx, gating, spec=rspec)
        assert torch.equal(t, twin)
        np.testing.assert_allclose(t.numpy(), np.asarray(r), **F32_TOL)
        assert all(bank != 3 for _dev, bank in TLEDGER.bank_accesses)
        assert TLEDGER.accesses > 3 * 30
        _same_ledger(rspec, tspec)


def test_slice_end_to_end_mlp_and_sdpa_on_a_banked_spec(ref_lowering):
    """Reduced gemma-2b, 2 decode slots, on 4 banks of 32-word tiles: the
    MLP (cold, then warm) and decode attention against the reference's
    lowered calls with the same spec; every ledger field and the bank
    report equal, outputs equal to the port's own unbanked calls."""
    rspec, tspec = _specs(**SPEC)
    rp, rx, tp, tx, gating = _mlp_inputs(seed=3)
    unbanked = tlayers.mlp_cim(tp, tx, gating)
    _reset()
    for warm in (False, True):
        TLEDGER.reset()
        RLEDGER.reset()
        before, r_before = tdisp.cache_stats(), rdisp.cache_stats()
        t = tlayers.mlp_cim(tp, tx, gating, spec=tspec)
        r = rlayers.mlp_cim(rp, rx, gating, spec=rspec)
        after, r_after = tdisp.cache_stats(), rdisp.cache_stats()
        assert torch.equal(t, unbanked)
        np.testing.assert_allclose(t.numpy(), np.asarray(r), **F32_TOL)
        for c in ("dispatches", "misses", "hits"):
            assert after[c] - before[c] == r_after[c] - r_before[c], c
        assert after["dispatches"] - before["dispatches"] == 3
        assert warm == (after["misses"] == before["misses"])
        _same_ledger(rspec, tspec)
    cfg = preset_config("gemma-2b", "reduced")
    rng = np.random.default_rng(4)
    hq, hkv, hd, t_max = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 9
    q = rng.normal(size=(2, 1, hq, hd)).astype(np.float32)
    k = rng.normal(size=(2, t_max, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(2, t_max, hkv, hd)).astype(np.float32)
    mask = (np.arange(t_max)[None, :] <= np.array([5, 8])[:, None])[:, None]
    scale = 1.0 / hd ** 0.5
    targs = [torch.from_numpy(a) for a in (q, k, v, mask)]
    flat = tattn.sdpa_cim(*targs, scale)
    _reset()
    t = tattn.sdpa_cim(*targs, scale, spec=tspec)
    r = rattn.sdpa_cim(*(jnp.asarray(a) for a in (q, k, v, mask)), scale,
                       spec=rspec)
    assert torch.equal(t, flat)
    np.testing.assert_allclose(t.numpy(), np.asarray(r), **F32_TOL)
    assert tdisp.cache_stats()["dispatches"] == 2
    assert len(TLEDGER.bank_accesses) == 4
    _same_ledger(rspec, tspec)


def test_resident_weights_on_the_paper_array(ref_lowering):
    """On the paper's array the reduced MLP's weight packs fit the resident
    budget: pinned once, reused warm, as the reference pins them."""
    rp, rx, tp, tx, gating = _mlp_inputs(seed=5)
    rspec, tspec = rarray.DEFAULT_SPEC, tarray.DEFAULT_SPEC
    for _ in range(2):
        TLEDGER.reset()
        RLEDGER.reset()
        t = tlayers.mlp_cim(tp, tx, gating, spec=tspec, resident=True)
        r = rlayers.mlp_cim(rp, rx, gating, spec=rspec, resident=True)
        np.testing.assert_allclose(t.numpy(), np.asarray(r), **F32_TOL)
        _same_ledger(rspec, tspec)
    assert TLEDGER.resident_reuses == 3
    assert tarray.resident_stats()["resident_pins"] == 3
