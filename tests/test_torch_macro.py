"""Port vs reference: access schedules, every macro, the engine's integer
wrappers, the program cache, and the resident/paged bookkeeping.

Schedules must match field for field; matmuls bit for bit with ledger
accesses equal to the plan; the dispatch/miss/hit counters must move
exactly as the reference's do.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import cim as rcim
from repro.cim import array as rarray
from repro.cim import dispatch as rdisp
from repro.cim import engine as reng
from repro.cim import macro as rmacro
from repro.cim import planner as rplan
from repro.cim.accounting import LEDGER as RLEDGER
from repro.cim.planepack import PlanePack as RPack
from repro.configs.registry import GEMMA_2B as R_GEMMA
from repro.launch.paged_kv import PagedKV as RPaged
from repro_torch import cim as tcim
from repro_torch.cim import array as tarray
from repro_torch.cim import dispatch as tdisp
from repro_torch.cim import engine as teng
from repro_torch.cim import macro as tmacro
from repro_torch.cim import planner as tplan
from repro_torch.cim.accounting import LEDGER as TLEDGER
from repro_torch.cim.opset import CimOpError
from repro_torch.cim.planepack import PlanePack as TPack
from repro_torch.configs.registry import GEMMA_2B as T_GEMMA
from repro_torch.launch.paged_kv import PagedKV as TPaged


@pytest.fixture(autouse=True)
def _fresh_state():
    for clear in (TLEDGER.reset, tarray.clear_resident,
                  tdisp.clear_schedule_cache, rdisp.clear_schedule_cache):
        clear()
    yield
    for clear in (TLEDGER.reset, tarray.clear_resident,
                  tdisp.clear_schedule_cache, rdisp.clear_schedule_cache):
        clear()


def _fields(s):
    return (s.macro, tuple((st.ops, st.role, st.shift, st.stride)
                           for st in s.steps),
            s.out_bits, s.placement, s.segments, s.operands, s.resident,
            s.accesses)


@pytest.mark.parametrize("plan,args,kw", [
    ("plan_multiply", (8, 8), {}),
    ("plan_multiply", (5, 1), {"signed_b": True}),
    ("plan_multiply", (7, 3), {"signed_b": False}),
    ("plan_reduce_sum", (37,), {"stride": 3, "n_bits": 16}),
    ("plan_matmul", (2048, 16384), {}),
    ("plan_matmul", (16384, 2048), {"resident_rhs": True}),
    ("plan_batched_matmul", (2, 256, 16), {}),
    ("plan_batched_matmul", (4, 16, 256), {"resident_rhs": True}),
])
def test_schedules_match_field_for_field(plan, args, kw):
    assert _fields(getattr(tplan, plan)(*args, **kw)) == \
        _fields(getattr(rplan, plan)(*args, **kw))


def test_serve_contraction_access_counts():
    """The per-decode-step arithmetic of the gemma-2b full-width serve:
    (2*8 - 1) + ceil(log2 K) accesses per contraction."""
    counts = [tplan.plan_matmul(k, 1).accesses for k in (2048, 2048, 16384)]
    counts += [tplan.plan_batched_matmul(1, k, 1).accesses for k in (256, 16)]
    assert counts == [26, 26, 29, 23, 19]
    assert 18 * sum(counts) == 2214


def _mm_inputs(seed, shape_a, shape_b):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, shape_a).astype(np.int32),
            rng.integers(-127, 128, shape_b).astype(np.int32))


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (3, 20, 5), (2, 64, 33)])
def test_matmul_bit_exact_ledger_and_counters(m, k, n):
    a, b = _mm_inputs(m * 100 + k, (m, k), (k, n))
    RLEDGER.reset()
    sched = tplan.plan_matmul(k, n)
    counters = []
    for _ in range(2):                                 # cold, then warm
        r0, t0 = rdisp.cache_stats(), tdisp.cache_stats()
        r = np.asarray(rmacro.matmul(jnp.asarray(a), jnp.asarray(b)))
        t = tmacro.matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        r1, t1 = rdisp.cache_stats(), tdisp.cache_stats()
        np.testing.assert_array_equal(t, r)
        np.testing.assert_array_equal(t, a.astype(np.int64) @ b)
        counters.append(tuple((t1[c] - t0[c], r1[c] - r0[c])
                              for c in ("dispatches", "misses", "hits")))
    assert counters == [((1, 1), (1, 1), (0, 0)), ((1, 1), (0, 0), (1, 1))]
    assert TLEDGER.accesses == RLEDGER.accesses == 2 * sched.accesses
    for f in ("load_accesses", "words32", "load_words32", "per_op"):
        assert getattr(TLEDGER, f) == getattr(RLEDGER, f), f


def test_batched_matmul_and_resident_rhs_match_reference():
    a, b = _mm_inputs(3, (2, 3, 4, 9), (2, 3, 9, 6))
    RLEDGER.reset()
    r = np.asarray(rmacro.batched_matmul(jnp.asarray(a), jnp.asarray(b)))
    t = tmacro.batched_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(t, r)
    np.testing.assert_array_equal(t, np.matmul(a.astype(np.int64), b))
    rp = rmacro.batched_matmul_rhs_pack(jnp.asarray(b), 4, 8)
    tp = tmacro.batched_matmul_rhs_pack(torch.from_numpy(b), 4, 8)
    np.testing.assert_array_equal(tp.planes.numpy().view(np.uint32),
                                  np.asarray(rp.planes))
    assert tuple(tp.shape) == tuple(rp.shape)
    r2 = np.asarray(rmacro.batched_matmul(jnp.asarray(a), b_pack=rp))
    t2 = tmacro.batched_matmul(torch.from_numpy(a), b_pack=tp).numpy()
    np.testing.assert_array_equal(t2, r2)
    a2, b2 = _mm_inputs(4, (3, 20), (20, 7))
    rp2 = rmacro.matmul_rhs_pack(jnp.asarray(b2), 3, 8)
    tp2 = tmacro.matmul_rhs_pack(torch.from_numpy(b2), 3, 8)
    np.testing.assert_array_equal(tp2.planes.numpy().view(np.uint32),
                                  np.asarray(rp2.planes))
    np.testing.assert_array_equal(
        tmacro.matmul(torch.from_numpy(a2), b_pack=tp2).numpy(),
        np.asarray(rmacro.matmul(jnp.asarray(a2), b_pack=rp2)))
    for f in ("accesses", "load_accesses", "resident_reuses",
              "resident_words32", "words32", "per_op"):
        assert getattr(TLEDGER, f) == getattr(RLEDGER, f), f


def test_bounded_lru_matches_reference():
    r, t = rdisp.BoundedLRU(2), tdisp.BoundedLRU(2)
    for op in ("a", "b", "a", "c", "b", "a", "d"):
        for lru in (r, t):
            if lru.get(op) is None:
                lru.put(op, op)
    assert t.stats() == r.stats()
    assert list(k for k, _ in t.items()) == list(k for k, _ in r.items())


def test_resident_set_and_paged_kv_bookkeeping_match_reference():
    rs_r = rarray.ResidentSet(rarray.DEFAULT_SPEC, reserve_rows=256)
    rs_t = tarray.ResidentSet(tarray.DEFAULT_SPEC, reserve_rows=256)
    for rs in (rs_r, rs_t):
        paged = (RPaged if rs is rs_r else TPaged).for_model(
            R_GEMMA if rs is rs_r else T_GEMMA, slots=2, max_len=16,
            resident_set=rs)
        assert paged.alloc(0, 8) and paged.alloc(1, 8)
        for _ in range(8):
            paged.extend(0)
        paged.free(1)
    assert rs_t.rows_per_bank() == rs_r.rows_per_bank()
    assert rs_t.reserves == rs_r.reserves
    for n_words in (1, 4096, 4097, 3 * 4096 + 5):
        assert rs_t._rows_for(8, n_words) == rs_r._rows_for(8, n_words)


# ---------------------------------------------------------------------------
# the rest of the macro surface: plans, engine wrappers, every macro
# ---------------------------------------------------------------------------

_RB = "jnp-boolean"           # the reference's plain backend


def _ledger_fields(led):
    import dataclasses
    return {f.name: (dict(getattr(led, f.name))
                     if isinstance(getattr(led, f.name), dict)
                     else getattr(led, f.name))
            for f in dataclasses.fields(led) if f.name != "enabled"}


def _same_ledger():
    """Every ledger field equal; word counts within 1e-12 relative."""
    r, t = _ledger_fields(RLEDGER), _ledger_fields(TLEDGER)
    assert r.keys() == t.keys()
    for k in r:
        if isinstance(r[k], float):
            assert t[k] == pytest.approx(r[k], rel=1e-12, abs=0), k
        else:
            assert t[k] == r[k], k


def _packs(x, n_bits, signed=True):
    return (RPack.pack(jnp.asarray(x), n_bits, signed=signed),
            TPack.pack(torch.from_numpy(np.asarray(x)), n_bits, signed=signed))


def _eq(t_pack, r_pack):
    assert t_pack.n_bits == r_pack.n_bits and t_pack.signed == r_pack.signed
    assert tuple(t_pack.shape) == tuple(r_pack.shape)
    np.testing.assert_array_equal(t_pack.unpack().numpy(),
                                  np.asarray(r_pack.unpack()))


@pytest.mark.parametrize("plan,args,kw", [
    ("plan_elementwise", (("sub", "lt"), 9), {}),
    ("plan_elementwise", (("xor",), 8), {"macro": "x"}),
    ("plan_neg", (8,), {}),
    ("plan_abs", (8,), {}),
    ("plan_relu", (5,), {}),
    ("plan_minimum", (16,), {}),
    ("plan_maximum", (3,), {}),
    ("plan_popcount", (1,), {}),
    ("plan_popcount", (13,), {}),
    ("plan_dot", (5,), {}),
    ("plan_dot", (64,), {"n_bits": 4, "signed": False}),
])
def test_new_plans_match_field_for_field(plan, args, kw):
    assert _fields(getattr(tplan, plan)(*args, **kw)) == \
        _fields(getattr(rplan, plan)(*args, **kw))


def test_concat_placement_and_traffic_model_match_reference():
    parts = [(p, a) for p, a in (("plan_minimum", (8,)),
                                 ("plan_multiply", (8, 8)),
                                 ("plan_reduce_sum", (70,)))]
    t = tplan.concat_schedules([getattr(tplan, p)(*a) for p, a in parts])
    r = rplan.concat_schedules([getattr(rplan, p)(*a) for p, a in parts])
    assert _fields(t) == _fields(r)
    with pytest.raises(CimOpError):
        tplan.concat_schedules([])
    tspec = tarray.ArraySpec(banks=2, subarrays=1, rows=128, bitline_words=32)
    rspec = rarray.ArraySpec(banks=2, subarrays=1, rows=128, bitline_words=32)
    tp, rp = t.placed(tspec, 100), r.placed(rspec, 100)
    assert (tp.placed_accesses, tp.placed_waves) == \
        (rp.placed_accesses, rp.placed_waves)
    for sched in ("plan_multiply", "plan_matmul"):
        args = (8, 8) if sched == "plan_multiply" else (70, 3)
        for resident in (False, True):
            ts, rs = getattr(tplan, sched)(*args), getattr(rplan, sched)(*args)
            if resident and sched == "plan_matmul":
                ts, rs = ts.with_resident("rhs"), rs.with_resident("rhs")
            assert tplan.schedule_traffic_bytes(ts, 8, 4096, 20) == \
                rplan.schedule_traffic_bytes(rs, 8, 4096, 20)
            assert tplan.schedule_traffic_bytes(ts, 8, 4096)["ratio"] > 1.5


def test_engine_integer_wrappers_match_reference():
    rng = np.random.default_rng(21)
    x = rng.integers(-2 ** 11, 2 ** 11, (3, 17)).astype(np.int32)
    y = rng.integers(-2 ** 11, 2 ** 11, (3, 17)).astype(np.int32)
    RLEDGER.reset()
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), \
        torch.from_numpy(x), torch.from_numpy(y)
    for name in ("add", "sub"):
        np.testing.assert_array_equal(
            getattr(teng, name)(tx, ty, 12).numpy(),
            np.asarray(getattr(reng, name)(jx, jy, 12, backend=_RB)))
    tc, rc = teng.compare(tx, ty, 12), reng.compare(jx, jy, 12, backend=_RB)
    for f in ("lt", "eq", "gt"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(rc, f)))
    for fn in ("xor", "nand", "a_or_not_b"):
        np.testing.assert_array_equal(
            teng.boolean(tx, ty, fn, 12).numpy(),
            np.asarray(reng.boolean(jx, jy, fn, 12, backend=_RB)))
    with pytest.raises(CimOpError, match="unknown Boolean function"):
        teng.boolean(tx, ty, "xorish", 12)
    (ra, ta), (rb, tb) = _packs(x, 12), _packs(y, 12)
    passes = (("sub",), ("lt", "eq"), ("xor",))
    tout = teng.execute_unfused(ta, tb, passes)
    rout = reng.execute_unfused(ra, rb, passes, backend=_RB)
    assert tout.keys() == rout.keys()
    for op in tout:
        _eq(tout[op], rout[op])
    _same_ledger()
    assert TLEDGER.accesses == 2 + 1 + 3 + len(passes)


def test_measured_traffic_charges_zero_and_matches_reference():
    rng = np.random.default_rng(22)
    (ra, ta) = _packs(rng.integers(-100, 100, 64), 8)
    (rb, tb) = _packs(rng.integers(-100, 100, 64), 9)
    for ops in (("xor", "sub"), ("lt", "eq", "gt"), ("add",)):
        t = teng.measured_traffic_bytes(ta, tb, ops)
        r = reng.measured_traffic_bytes(ra, rb, ops, backend=_RB)
        assert t == r
    assert TLEDGER.accesses == 0 and TLEDGER.words32 == 0


@pytest.mark.parametrize("signed", [True, False])
def test_multiply_parity_and_ledger(signed):
    rng = np.random.default_rng(23 + signed)
    lo = -8 if signed else 0
    x, y = rng.integers(lo, 8, 40), rng.integers(lo, 8, 40)
    (ra, ta), (rb, tb) = _packs(x, 4, signed), _packs(y, 4, signed)
    RLEDGER.reset()
    t = tmacro.multiply(ta, tb)
    r = rmacro.multiply(ra, rb, backend=_RB)
    _eq(t, r)
    np.testing.assert_array_equal(t.unpack().numpy(), x * y)
    _same_ledger()


@pytest.mark.parametrize("wa,wb,signed", [(8, 8, True), (8, 8, False),
                                          (5, 3, True), (4, 1, True),
                                          (4, 1, False), (7, 3, True)])
def test_multiply_widths_charge_exactly_their_plan(wa, wb, signed):
    rng = np.random.default_rng(wa * 10 + wb)
    x = rng.integers(0, 2 ** (wa - 1), 16)
    y = rng.integers(0, max(1, 2 ** (wb - 1)), 16)
    (ra, ta), (rb, tb) = _packs(x, wa, signed), _packs(y, wb, signed)
    RLEDGER.reset()
    _eq(tmacro.multiply(ta, tb), rmacro.multiply(ra, rb, backend=_RB))
    assert TLEDGER.accesses == \
        tplan.plan_multiply(wa, wb, signed_b=signed).accesses
    _same_ledger()


def test_int_min_edges():
    """INT_MIN x INT_MIN needs the full 2n-bit product; abs(INT_MIN) is
    exact on its n+1 planes; relu, min and max at both ends."""
    x = np.array([-128, -128, -1, 127, 0, -127], np.int32)
    y = np.array([-128, 127, -1, 127, -1, 0], np.int32)
    (ra, ta), (rb, tb) = _packs(x, 8), _packs(y, 8)
    RLEDGER.reset()
    p = tmacro.multiply(ta, tb)
    _eq(p, rmacro.multiply(ra, rb, backend=_RB))
    np.testing.assert_array_equal(p.unpack().numpy(), x * y)
    a = tmacro.abs_(ta)
    assert a.n_bits == 9 and int(a.unpack()[0]) == 128
    _eq(a, rmacro.abs_(ra, backend=_RB))
    for name, want in (("relu", np.maximum(x, 0)),):
        t = getattr(tmacro, name)(ta)
        _eq(t, getattr(rmacro, name)(ra, backend=_RB))
        np.testing.assert_array_equal(t.unpack().numpy(), want)
    for name, want in (("minimum", np.minimum(x, y)),
                       ("maximum", np.maximum(x, y))):
        t = getattr(tmacro, name)(ta, tb)
        _eq(t, getattr(rmacro, name)(ra, rb, backend=_RB))
        np.testing.assert_array_equal(t.unpack().numpy(), want)
    _same_ledger()


def test_select_macros_are_single_access_and_select_matches():
    rng = np.random.default_rng(24)
    x, y = rng.integers(-100, 100, 32), rng.integers(0, 200, 32)
    (ra, ta), (rb, tb) = _packs(x, 8), _packs(y, 9, signed=False)
    for fn in ("abs_", "relu"):
        TLEDGER.reset()
        getattr(tmacro, fn)(ta)
        assert TLEDGER.accesses == 1
    for fn in ("minimum", "maximum"):
        TLEDGER.reset()
        getattr(tmacro, fn)(ta, ta)
        assert TLEDGER.accesses == 1
    rpred = reng.execute(ra, ra, ("lt",), backend=_RB)["lt"]
    tpred = teng.execute(ta, ta, ("lt",))["lt"]
    _eq(tmacro.select(tpred, ta, tb), rmacro.select(rpred, ra, rb))
    with pytest.raises(CimOpError, match="1-plane"):
        tmacro.select(ta, ta, tb)


@pytest.mark.parametrize("n_bits", [1, 2, 3, 5, 8, 16])
def test_popcount_parity_and_n_minus_1_accesses(n_bits):
    rng = np.random.default_rng(n_bits)
    x = rng.integers(-(2 ** (n_bits - 1)), 2 ** (n_bits - 1), 33)
    ra, ta = _packs(x, n_bits)
    RLEDGER.reset()
    t = tmacro.popcount(ta)
    _eq(t, rmacro.popcount(ra, backend=_RB))
    mask = (1 << n_bits) - 1
    np.testing.assert_array_equal(
        t.unpack().numpy(), [bin(int(v) & mask).count("1") for v in x])
    assert TLEDGER.accesses == n_bits - 1
    _same_ledger()


@pytest.mark.parametrize("n,want", [(1, 0), (2, 1), (3, 2), (31, 5),
                                    (64, 6), (100, 7)])
def test_reduce_sum_parity_and_log2_accesses(n, want):
    rng = np.random.default_rng(n)
    x = rng.integers(-100, 100, n)
    ra, ta = _packs(x, 8)
    RLEDGER.reset()
    t = tmacro.reduce_sum(ta)
    _eq(t, rmacro.reduce_sum(ra, backend=_RB))
    assert t.shape == () and int(t.unpack()) == int(x.sum())
    assert TLEDGER.accesses == want == tplan.plan_reduce_sum(n).accesses
    _same_ledger()


@pytest.mark.parametrize("k", [1, 2, 5, 16])
def test_dot_parity_and_accesses(k):
    a, b = _mm_inputs(k, (k,), (k,))
    RLEDGER.reset()
    t = tmacro.dot(torch.from_numpy(a), torch.from_numpy(b))
    r = rmacro.dot(jnp.asarray(a), jnp.asarray(b), backend=_RB)
    assert int(t) == int(r) == int(a.astype(np.int64) @ b)
    assert TLEDGER.accesses == tplan.plan_dot(k).accesses
    _same_ledger()


def test_int_wrappers_match_reference():
    rng = np.random.default_rng(25)
    x = rng.integers(-3000, 3000, 50).astype(np.int32)
    y = rng.integers(-3000, 3000, 50).astype(np.int32)
    tx, ty, jx, jy = torch.from_numpy(x), torch.from_numpy(y), \
        jnp.asarray(x), jnp.asarray(y)
    RLEDGER.reset()
    for name in ("multiply_ints", "minimum_ints", "maximum_ints"):
        np.testing.assert_array_equal(
            getattr(tmacro, name)(tx, ty).numpy(),
            np.asarray(getattr(rmacro, name)(jx, jy, backend=_RB)))
    for name in ("relu_ints", "abs_ints", "popcount_ints",
                 "reduce_sum_ints"):
        np.testing.assert_array_equal(
            getattr(tmacro, name)(tx).numpy(),
            np.asarray(getattr(rmacro, name)(jx, backend=_RB)))
    _same_ledger()


def test_matmul_rejects_bad_shapes():
    with pytest.raises(CimOpError):
        tmacro.matmul(torch.ones((2, 3), dtype=torch.int32),
                      torch.ones((4, 2), dtype=torch.int32))
    with pytest.raises(CimOpError):
        tmacro.batched_matmul(torch.ones((2, 2, 3), dtype=torch.int32),
                              torch.ones((2, 4, 2), dtype=torch.int32))


def test_cursor_refuses_unplanned_extra_and_missing_accesses():
    a = TPack.pack(torch.arange(-4, 4), 8)
    z = TPack.zeros_like(a)
    cur = tmacro.ScheduleCursor(tplan.plan_relu(8))
    with pytest.raises(CimOpError, match="plan says"):
        cur.execute(a, a, ("add",))
    cur.execute(a, z, ("gt",))
    with pytest.raises(CimOpError, match="exceeded"):
        cur.execute(a, z, ("gt",))
    with pytest.raises(CimOpError, match="executed 0 of"):
        tmacro.ScheduleCursor(tplan.plan_multiply(4, 4)).finish()


def test_package_exports_the_reference_surface():
    """Every name the reference's `repro.cim` exports from the modules the
    port holds, save the fault layer and the mesh path."""
    later = {"set_resident_ecc", "execute_sharded", "DEFAULT_BLOCK_W",
             "on_tpu", "set_default_backend"}
    mods = ("accounting", "array", "dispatch", "engine", "macro", "opset",
            "planepack", "planner", "backends", "fused_kernel")
    want = {n for n in dir(rcim) if not n.startswith("_")
            and getattr(getattr(rcim, n), "__module__", "").rsplit(".", 1)[-1]
            in mods} - later
    assert want and want <= set(dir(tcim)), sorted(want - set(dir(tcim)))
