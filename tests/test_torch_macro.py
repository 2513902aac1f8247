"""Port vs reference: access schedules, macro matmuls, the program cache,
and the resident/paged bookkeeping.

Schedules must match field for field; matmuls bit for bit with ledger
accesses equal to the plan; the dispatch/miss/hit counters must move
exactly as the reference's do.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cim import array as rarray
from repro.cim import dispatch as rdisp
from repro.cim import macro as rmacro
from repro.cim import planner as rplan
from repro.cim.accounting import LEDGER as RLEDGER
from repro.configs.registry import GEMMA_2B as R_GEMMA
from repro.launch.paged_kv import PagedKV as RPaged
from repro_torch.cim import array as tarray
from repro_torch.cim import dispatch as tdisp
from repro_torch.cim import macro as tmacro
from repro_torch.cim import planner as tplan
from repro_torch.cim.accounting import LEDGER as TLEDGER
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


def test_entry_bits_charges_the_region_entry_loads():
    """`entry_bits` adds one load per streamed int32 operand, as the
    reference's lowered region charges for its convert inputs."""
    a, b = _mm_inputs(5, (2, 16), (16, 32))
    tmacro.matmul(torch.from_numpy(a), torch.from_numpy(b), entry_bits=32)
    assert TLEDGER.load_accesses == 4
    assert TLEDGER.load_words32 == (2 * 16 + 16 * 32) + 2 * (2 * 16 * 32) / 4


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
