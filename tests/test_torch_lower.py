"""Port vs reference: the lowering compiler (`cim/trace.py`, `cim/lower.py`)
and its applications (`mlp_cim`, `cim_linear`, `sdpa_cim`,
`blockwise_attention_cim`).

`lower(fn)` must be bit-exact with plain `fn` for any composition of
eligible ops, int8 wrap and unsigned semantics included; fused regions must
charge exactly their plan and run as one dispatch each, cold and warm; and
on twin functions (written once in jnp, once in torch with explicit dtypes
so both captures hold the same ops) the region count, accesses, loads,
`per_op`, dispatches and cache counters must equal the reference's
lowering. Random graphs are compared with jnp's results on the same numpy
inputs, since torch's CPU build lacks most uint16/uint32 kernels: a uint16
op left on the host raises NotImplementedError, asserted by its own test
(ROADMAP C). The reference's lowering needs the
`jax.core.Literal`/`Var` aliases under JAX 0.9, applied per test; its
`jnp.where` becomes a nested `jit` there that it no longer inlines, so its
twins use `jax.lax.select`. The analog-oracle and offload-estimator
cases are in `tests/test_torch_analog.py` and `tests/test_torch_offload.py`;
the mesh cases over gloo ranks are in `tests/test_torch_sharding.py`.
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
from repro.cim.accounting import LEDGER as RLEDGER
from repro.cim.array import ArraySpec as RSpec
from repro.cim.lower import lower as rlower
from repro.models import attention as rattn
from repro.models import blockwise_attention as rblock
from repro.models import layers as rlayers
from repro_torch.cim import array as tarray
from repro_torch.cim import dispatch as tdisp
from repro_torch.cim.accounting import LEDGER as TLEDGER
from repro_torch.cim.array import ArraySpec as TSpec
from repro_torch.cim.lower import SIGNATURE_CACHE_CAPACITY, lower
from repro_torch.cim.opset import CimOpError
from repro_torch.cim.trace import int_contract, population_count
from repro_torch.core.bitplane import (codec_call_counts,
                                       reset_codec_call_counts)
from repro_torch.models import attention as tattn
from repro_torch.models import blockwise_attention as tblock
from repro_torch.models import layers as tlayers

#: float tolerance against the reference's float islands (quantize scales,
#: softmax, gating): both contract the same integers exactly
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BACKENDS = (None, "torch-boolean")
SMALL = dict(banks=2, subarrays=1, rows=256, bitline_words=32)


def _reset():
    for clear in (TLEDGER.reset, RLEDGER.reset, tarray.clear_resident,
                  rarray.clear_resident, tdisp.clear_schedule_cache,
                  rdisp.clear_schedule_cache):
        clear()


@pytest.fixture(autouse=True)
def _fresh_state():
    _reset()
    yield
    _reset()
    for cache in (tlayers._LOWERED_MLP, tlayers._LOWERED_LINEAR,
                  tattn._LOWERED_SDPA, tblock._LOWERED_BMM):
        cache.clear()


@pytest.fixture
def ref_lowering(monkeypatch):
    """The reference's lowering under JAX 0.9, for this test only."""
    monkeypatch.setattr(jax.core, "Literal", jex.Literal, raising=False)
    monkeypatch.setattr(jax.core, "Var", jex.Var, raising=False)
    yield
    rlayers._LOWERED_MLP.clear()
    rlayers._LOWERED_LINEAR.clear()
    rattn._LOWERED_SDPA.clear()
    rblock._LOWERED_BMM.clear()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _leaves(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _assert_equal(got, want):
    """Equal values AND dtypes, leaf by leaf (`want` numpy/jax or torch)."""
    got_l, want_l = _leaves(got), _leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.numpy().dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w)


def _ledger():
    return {f.name: (dict(getattr(TLEDGER, f.name))
                     if isinstance(getattr(TLEDGER, f.name), dict)
                     else getattr(TLEDGER, f.name))
            for f in dataclasses.fields(TLEDGER) if f.name != "enabled"}


# ---------------------------------------------------------------------------
# randomly composed graphs
# ---------------------------------------------------------------------------

DTYPES = ("int8", "int16", "int32", "uint8", "uint16")
_SUM_DTYPE = {"int8": "int32", "int16": "int32", "uint8": "uint32",
              "uint16": "uint32"}
_N_STEP_KINDS = 15


def _edge_operand(dtype, n_words, seed):
    """Random operand with MIN / MAX / 0 / 1 edges forced in."""
    info = np.iinfo(dtype)
    rng = np.random.RandomState(seed)
    edges = np.array([info.min, info.max, 0, 1, info.min + 1, info.max - 1],
                     np.int64)
    vals = np.concatenate([edges, rng.randint(
        int(info.min), int(info.max) + 1, max(0, n_words - len(edges)),
        dtype=np.int64)])[:n_words]
    rng.shuffle(vals)
    return vals.astype(dtype)


def _jnp_step(kind, sel, vals):
    x = vals[sel % len(vals)]
    y = vals[(sel // 7) % len(vals)]
    if x.dtype != y.dtype:
        y = y.astype(x.dtype)
    k = kind % _N_STEP_KINDS
    if k == 0:
        return x + y
    if k == 1:
        return x - y
    if k == 2:
        return x * y
    if k == 3:
        return jnp.bitwise_and(x, y)
    if k == 4:
        return jnp.bitwise_or(x, y)
    if k == 5:
        return jnp.bitwise_xor(x, y)
    if k == 6:
        return jnp.minimum(x, y)
    if k == 7:
        return jnp.maximum(x, y)
    if k == 8:
        return -x
    if k == 9:
        return ~x
    if k == 10:
        cmp = (x < y, x <= y, x > y, x >= y, x == y, x != y)[sel % 6]
        return jnp.where(cmp, x, y)
    if k == 11:
        return x.astype(jnp.int8).astype(x.dtype)
    if k == 12:
        return jnp.floor(x.astype(jnp.float32) / 3.0).astype(x.dtype)
    if k == 13:
        return x + jnp.sum(x)
    return jnp.abs(x)


def _torch_step(kind, sel, vals):
    """The same step in torch, dtypes named where jnp promotes."""
    x = vals[sel % len(vals)]
    y = vals[(sel // 7) % len(vals)]
    if x.dtype != y.dtype:
        y = y.to(x.dtype)
    k = kind % _N_STEP_KINDS
    if k == 0:
        return x + y
    if k == 1:
        return x - y
    if k == 2:
        return x * y
    if k == 3:
        return x & y
    if k == 4:
        return x | y
    if k == 5:
        return x ^ y
    if k == 6:
        return torch.minimum(x, y)
    if k == 7:
        return torch.maximum(x, y)
    if k == 8:
        return -x
    if k == 9:
        return ~x
    if k == 10:
        cmp = (x < y, x <= y, x > y, x >= y, x == y, x != y)[sel % 6]
        return torch.where(cmp, x, y)
    if k == 11:
        return x.to(torch.int8).to(x.dtype)
    if k == 12:
        return torch.floor(x.float() / 3.0).to(x.dtype)
    if k == 13:
        name = str(x.dtype)[len("torch."):]
        acc = getattr(torch, _SUM_DTYPE.get(name, name))
        xs = x if x.dtype == acc else x.to(acc)
        return (x if x.dtype == acc else x.to(acc)) \
            + torch.sum(xs, dtype=acc)
    return torch.abs(x)


def _graphs(steps):
    def jfn(a, b, c):
        vals = [a, b, c]
        for kind, sel in steps:
            vals.append(_jnp_step(kind, sel, vals))
        return tuple(vals[-3:])

    def tfn(a, b, c):
        vals = [a, b, c]
        for kind, sel in steps:
            vals.append(_torch_step(kind, sel, vals))
        return tuple(vals[-3:])

    return jfn, tfn


@pytest.mark.parametrize("seed", range(30))
def test_random_composed_graphs_bit_exact(seed):
    """Random graphs over the whole eligible surface plus a float island,
    MIN/MAX/0/1 edges forced in: the lowered result equals jnp's (and
    torch's own where its CPU build has the dtype's kernels), and one
    execution charges exactly the plan."""
    rng = np.random.RandomState(seed)
    dtype = DTYPES[seed % len(DTYPES)]
    steps = [(int(rng.randint(0, _N_STEP_KINDS)), int(rng.randint(0, 10_000)))
             for _ in range(int(rng.randint(2, 9)))]
    jfn, tfn = _graphs(steps)
    args = [_edge_operand(dtype, 12, seed + i) for i in range(3)]
    want = jfn(*args)
    targs = [_t(a) for a in args]
    for backend in BACKENDS:
        lf = lower(tfn, backend=backend)
        comp = lf.trace(*targs)
        TLEDGER.reset()
        _assert_equal(lf(*targs), want)
        assert TLEDGER.accesses == comp.accesses
    if dtype in ("int8", "int16", "int32"):
        _assert_equal(tfn(*targs), want)


def test_uint16_graph_in_the_array_matches_jnp():
    """uint16 semantics where every op lowers (so no host kernel is
    needed): wrap-around add/sub/mul/neg, compare + select, min/max, abs,
    bitwise, a sum promoted to uint32."""
    def jfn(u, v):
        w = jnp.where(u < v, u * v, -u)
        return w + (u - v), jnp.maximum(u, v) ^ jnp.abs(v), \
            u.astype(jnp.uint32) + jnp.sum(u)

    def tfn(u, v):
        w = torch.where(u < v, u * v, -u)
        return w + (u - v), torch.maximum(u, v) ^ torch.abs(v), \
            u.to(torch.uint32) + torch.sum(u.to(torch.uint32),
                                           dtype=torch.uint32)

    u = _edge_operand(np.uint16, 40, 1)
    v = _edge_operand(np.uint16, 40, 2)
    lf = lower(tfn)
    comp = lf.trace(_t(u), _t(v))
    assert comp.host_eqns == 0 and len(comp.regions) == 1
    _assert_equal(lf(_t(u), _t(v)), jfn(u, v))


def test_uint16_host_op_without_a_cpu_kernel_raises():
    """A uint16 op left on the host (a lone bitwise_not: a run of free ops
    only is hosted) needs torch's CPU kernel, which torch lacks for UInt16:
    the lowering raises it, it does not fall back. In the array the same op
    is exact (the test above); on the card torch has the kernel."""
    u = _t(_edge_operand(np.uint16, 8, 0))
    lf = lower(lambda x: ~x)
    comp = lf.trace(u)
    assert comp.host_eqns == 1 and not comp.regions
    with pytest.raises(NotImplementedError, match="UInt16"):
        lf(u)


# ---------------------------------------------------------------------------
# fusion structure
# ---------------------------------------------------------------------------


def test_chain_fuses_into_single_schedule_zero_repacks():
    """Three chained ops fuse into ONE region Schedule: three entry packs,
    one exit unpack, nothing between the chained ops."""
    def fn(a, b, c):
        return ((a + b) - c) ^ a

    a = torch.arange(-16, 16, dtype=torch.int16)
    b, c = a + 3, a - 7
    lf = lower(fn)
    comp = lf.trace(a, b, c)
    assert len(comp.regions) == 1
    region = comp.regions[0]
    assert len(region.ops) == 3 and region.accesses == 3
    assert region.schedule.segments == (("add", 1), ("sub", 1), ("xor", 1))
    reset_codec_call_counts()
    TLEDGER.reset()
    out = lf(a, b, c)
    assert codec_call_counts() == {"pack": 3, "unpack": 1}
    assert TLEDGER.accesses == 3
    assert torch.equal(out, fn(a, b, c))


def test_compare_select_chain_is_one_access():
    """lt + both selects of a tournament level fuse to a single access."""
    def fn(a, b, ia, ib):
        take_b = a < b
        return torch.where(take_b, b, a), torch.where(take_b, ib, ia)

    a = torch.tensor([3, -9, 5, 7], dtype=torch.int16)
    b = torch.tensor([3, 4, -5, 9], dtype=torch.int16)
    ia = torch.arange(4, dtype=torch.int32)
    lf = lower(fn)
    comp = lf.trace(a, b, ia, ia + 4)
    assert len(comp.regions) == 1 and comp.accesses == 1
    TLEDGER.reset()
    _assert_equal(lf(a, b, ia, ia + 4), fn(a, b, ia, ia + 4))
    assert TLEDGER.accesses == 1


def test_mixed_graph_splits_regions_at_host_ops():
    def fn(a, b):
        t = (a + b) * b
        f = torch.sin(t.float())
        q = torch.round(f * 100.0).to(torch.int32)
        return (q - a) ^ b

    a = torch.arange(-8, 8, dtype=torch.int32)
    b = 3 - a
    lf = lower(fn)
    comp = lf.trace(a, b)
    assert len(comp.regions) == 2
    assert comp.host_eqns >= 3
    assert torch.equal(lf(a, b), fn(a, b))


def test_nested_function_output_reused_inside():
    """A nested function whose returned intermediate also feeds another op
    inside it: the capture records aten ops only, so all three fuse."""
    def g(x):
        t = x + 1
        return t, t * 2

    def fn(x):
        a, b = g(x)
        return a - b

    x = torch.arange(-8, 8, dtype=torch.int16)
    lf = lower(fn)
    comp = lf.trace(x)
    assert len(comp.regions) == 1 and len(comp.regions[0].ops) == 3
    assert torch.equal(lf(x), fn(x))


def test_constants_inputs_and_duplicates_as_outputs():
    """Outputs that are a closed-over constant, a constant made inside the
    function, an input, or the same value twice come out right."""
    c = torch.arange(3, dtype=torch.int16)

    def fn(x):
        t = x + 1
        k = torch.tensor([7, -7, 1], dtype=torch.int16)
        return t, c, x, t, k, t * k

    x = torch.arange(3, dtype=torch.int16)
    lf = lower(fn)
    comp = lf.trace(x)
    assert len(comp.regions) == 1
    got = lf(x)
    _assert_equal(got, fn(x))
    assert got[0] is got[3]


def test_purely_free_runs_execute_on_host():
    def fn(a):
        return a.to(torch.int16).reshape(4, 2).to(torch.int32)

    a = torch.arange(8, dtype=torch.int32)
    lf = lower(fn)
    comp = lf.trace(a)
    assert len(comp.regions) == 0 and comp.accesses == 0
    TLEDGER.reset()
    assert torch.equal(lf(a), fn(a))
    assert TLEDGER.accesses == 0


def test_contraction_fused_with_elementwise():
    def fn(x, w, bias):
        return int_contract(x, w) + bias

    rng = np.random.RandomState(0)
    x = _t(rng.randint(-128, 128, (4, 6)).astype(np.int8))
    w = _t(rng.randint(-128, 128, (6, 3)).astype(np.int8))
    bias = torch.arange(3, dtype=torch.int32)
    lf = lower(fn)
    comp = lf.trace(x, w, bias)
    assert len(comp.regions) == 1
    TLEDGER.reset()
    assert torch.equal(lf(x, w, bias), fn(x, w, bias))
    assert TLEDGER.accesses == comp.accesses


def test_batched_contraction_and_popcount_lower():
    rng = np.random.RandomState(1)
    a = _t(rng.randint(-128, 128, (2, 3, 4, 5)).astype(np.int8))
    b = _t(rng.randint(-128, 128, (2, 3, 5, 6)).astype(np.int8))
    p = _t(rng.randint(-2 ** 15, 2 ** 15, 33).astype(np.int16))

    def fn(a, b, p):
        return int_contract(a, b), population_count(p) + p

    lf = lower(fn)
    comp = lf.trace(a, b, p)
    names = [op.name for r in comp.regions for op in r.ops]
    assert "dot_general" in names and "population_count" in names
    _assert_equal(lf(a, b, p), fn(a, b, p))
    want = np.asarray(jax.lax.population_count(jnp.asarray(p.numpy())))
    np.testing.assert_array_equal(population_count(p).numpy(), want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_int8_wrap_and_unsigned_semantics(backend):
    def fn(s, u):
        return s * s, s + s, u + u, -u, u * u

    s = np.array([-128, -1, 127, 100, -100, 0, 1, 64], np.int8)
    u = np.array([0, 255, 128, 200, 1, 99, 250, 7], np.uint8)
    got = lower(fn, backend=backend)(_t(s), _t(u))
    _assert_equal(got, jax.jit(fn)(s, u))
    _assert_equal(got, fn(_t(s), _t(u)))


def test_bool_predicates_and_logic_stay_packed():
    def fn(a, b):
        p = a != b
        q = a >= b
        return p & q, p ^ q, p

    a = torch.tensor([-5, 0, 3, 3, 9, -1], dtype=torch.int16)
    b = torch.tensor([-5, 1, -3, 3, 2, -1], dtype=torch.int16)
    lf = lower(fn)
    comp = lf.trace(a, b)
    assert len(comp.regions) == 1
    _assert_equal(lf(a, b), fn(a, b))


def test_mesh_waits_and_signature_cache_is_bounded():
    """`lower(mesh=)` reaches the dispatcher, which refuses a mesh without
    the "data" axis; the signature cache stays bounded."""
    spec = TSpec(banks=2, subarrays=1, rows=64, bitline_words=32)
    with pytest.raises(CimOpError, match="no 'data'"):
        lower(lambda a: a + a, spec=spec, mesh=object())(
            torch.arange(40, dtype=torch.int16))
    lf = lower(lambda a: a + a)
    for n in range(SIGNATURE_CACHE_CAPACITY + 3):
        lf(torch.arange(n + 1, dtype=torch.int16))
    assert len(lf._cache) == SIGNATURE_CACHE_CAPACITY


# ---------------------------------------------------------------------------
# rewired callers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gating", ["swiglu", "geglu", "gelu"])
def test_mlp_cim_is_a_lowered_application(gating):
    gen = torch.Generator().manual_seed(0)
    p = tlayers.mlp_init(gen, 8, 16, gating, torch.float32, "cpu")
    x = torch.randn((2, 3, 8), generator=gen)
    lf = tlayers._lowered_mlp(gating, 8, None, None)
    comp = lf.trace(p, x)
    assert len(comp.regions) == (3 if gating != "gelu" else 2)
    TLEDGER.reset()
    out = tlayers.mlp_cim(p, x, gating, n_bits=8)
    assert TLEDGER.accesses == comp.accesses
    assert torch.equal(out, tlayers._mlp_quantized(p, x, gating, 8))


def test_region_entry_loads_match_reference(ref_lowering):
    """A contraction region's int32 entry packs are real loads: [2, 16] x
    [16, 32] charges 2 entry packs at 32 bits and 2 expanded packs at 8,
    as the reference's lowered region does."""
    rng = np.random.RandomState(5)
    a = rng.randint(-127, 128, (2, 16)).astype(np.int32)
    b = rng.randint(-127, 128, (16, 32)).astype(np.int32)
    out = lower(lambda x, w: int_contract(x.to(torch.int8),
                                          w.to(torch.int8)))(_t(a), _t(b))
    rout = rlower(lambda x, w: jnp.matmul(
        x.astype(jnp.int8), w.astype(jnp.int8),
        preferred_element_type=jnp.int32), backend="jnp-boolean")(a, b)
    np.testing.assert_array_equal(out.numpy(), np.asarray(rout))
    assert TLEDGER.load_accesses == RLEDGER.load_accesses == 4
    assert TLEDGER.load_words32 == RLEDGER.load_words32 == \
        (2 * 16 + 16 * 32) + 2 * (2 * 16 * 32) / 4
    assert TLEDGER.accesses == RLEDGER.accesses


# ---------------------------------------------------------------------------
# region counts, accesses, loads and per_op equal to the reference's
# ---------------------------------------------------------------------------


def _twins():
    """(name, jnp fn, torch fn, numpy args)."""
    rng = np.random.RandomState(7)
    a16 = rng.randint(-300, 300, 40).astype(np.int16)
    b16 = rng.randint(-300, 300, 40).astype(np.int16)
    a8 = rng.randint(-100, 100, 40).astype(np.int8)
    b8 = rng.randint(-100, 100, 40).astype(np.int8)
    x8 = rng.randint(-128, 128, (4, 6)).astype(np.int8)
    w8 = rng.randint(-128, 128, (6, 3)).astype(np.int8)
    xf = rng.normal(size=(2, 3, 8)).astype(np.float32)
    wf = rng.normal(size=(8, 16)).astype(np.float32)
    qf = rng.normal(size=(2, 2, 4, 8)).astype(np.float32)
    kf = rng.normal(size=(2, 2, 8, 5)).astype(np.float32)

    def j_mixed(a, b):
        t = (a + b) * b
        q = jnp.round(jnp.sin(t.astype(jnp.float32)) * 100.0) \
            .astype(jnp.int8)
        return jax.lax.select(q < a, q - a, b) ^ b, jnp.sum(t)

    def t_mixed(a, b):
        t = (a + b) * b
        q = torch.round(torch.sin(t.float()) * 100.0).to(torch.int8)
        return torch.where(q < a, q - a, b) ^ b, \
            torch.sum(t.to(torch.int32), dtype=torch.int32)

    return [
        ("chain", lambda a, b: ((a + b) - b) ^ a,
         lambda a, b: ((a + b) - b) ^ a, (a16, b16)),
        ("mixed", j_mixed, t_mixed, (a8, b8)),
        ("contraction", lambda x, w: jnp.matmul(
            x, w, preferred_element_type=jnp.int32) + 3,
         lambda x, w: int_contract(x, w) + 3, (x8, w8)),
        ("linear", lambda x, w: rlayers._quantized_linear(x, w, 8),
         lambda x, w: tlayers._quantized_linear(x, w, 8), (xf, wf)),
        ("batched", lambda a, b: rlayers.quantized_batched_matmul(a, b, 8),
         lambda a, b: tlayers.quantized_batched_matmul(a, b, 8), (qf, kf)),
    ]


_LEDGER_FIELDS = ("accesses", "load_accesses", "load_words32",
                  "resident_reuses", "words32", "per_op", "bank_accesses",
                  "activated_words32", "inter_bank_words32")


@pytest.mark.parametrize("banked", [False, True])
@pytest.mark.parametrize("case", range(5))
def test_lowering_matches_reference(ref_lowering, case, banked):
    name, jfn, tfn, args = _twins()[case]
    rspec = RSpec(**SMALL) if banked else None
    tspec = TSpec(**SMALL) if banked else None
    rlf = rlower(jfn, backend="jnp-boolean", spec=rspec)
    tlf = lower(tfn, spec=tspec)
    rcomp = rlf.trace(*args)
    tcomp = tlf.trace(*(_t(a) for a in args))
    assert len(tcomp.regions) == len(rcomp.regions), name
    assert [len(r.ops) for r in tcomp.regions] == \
        [len(r.ops) for r in rcomp.regions], name
    assert tcomp.accesses == rcomp.accesses, name
    for _ in range(2):                                  # cold, then warm
        _reset()
        r0, t0 = rdisp.cache_stats(), tdisp.cache_stats()
        rout = rlf(*args)
        tout = tlf(*(_t(a) for a in args))
        r1, t1 = rdisp.cache_stats(), tdisp.cache_stats()
        for g, w in zip(_leaves(tout), _leaves(rout)):
            if g.dtype.is_floating_point:
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           **F32_TOL)
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for f in _LEDGER_FIELDS:
            r, t = getattr(RLEDGER, f), getattr(TLEDGER, f)
            if isinstance(r, float):
                assert t == pytest.approx(r, rel=1e-12), (name, f)
            else:
                assert t == r, (name, f)
        for c in ("dispatches", "misses", "hits"):
            assert t1[c] - t0[c] == r1[c] - r0[c], (name, c)


@pytest.mark.parametrize("gating", ["swiglu", "geglu"])
def test_mlp_cim_counts_match_reference(ref_lowering, gating):
    """mlp_cim streamed, then resident (pinned cold, reused warm): the same
    regions, accesses, loads, per_op, dispatches and pins/hits as the
    reference's lowered MLP on the same weights."""
    rng = np.random.RandomState(11)
    p = {"w_in": rng.normal(size=(8, 16)).astype(np.float32),
         "w_gate": rng.normal(size=(8, 16)).astype(np.float32),
         "w_out": rng.normal(size=(16, 8)).astype(np.float32)}
    x = rng.normal(size=(2, 1, 8)).astype(np.float32)
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    for resident in (False, True, True):
        RLEDGER.reset()
        TLEDGER.reset()
        r0, t0 = rdisp.cache_stats(), tdisp.cache_stats()
        r = rlayers.mlp_cim(rp, jnp.asarray(x), gating, resident=resident,
                            backend="jnp-boolean")
        t = tlayers.mlp_cim(tp, _t(x), gating, resident=resident)
        r1, t1 = rdisp.cache_stats(), tdisp.cache_stats()
        np.testing.assert_allclose(t.numpy(), np.asarray(r), **F32_TOL)
        assert torch.equal(t, tlayers._mlp_quantized(tp, _t(x), gating, 8))
        for f in _LEDGER_FIELDS:
            assert getattr(TLEDGER, f) == getattr(RLEDGER, f), f
        for c in ("dispatches", "misses", "hits", "resident_pins",
                  "resident_hits"):
            assert t1[c] - t0[c] == r1[c] - r0[c], c
        assert t1["dispatches"] - t0["dispatches"] == 3


# ---------------------------------------------------------------------------
# region programs: one dispatch per region, sharing, dead inputs
# ---------------------------------------------------------------------------


def _ints(seed, lo, hi, n, dtype=torch.int16):
    rng = np.random.RandomState(seed)
    return _t(rng.randint(lo, hi, n).astype(np.int32)).to(dtype)


@pytest.mark.parametrize("banked", [False, True])
def test_lowered_region_one_dispatch_cold_warm_parity(banked):
    def fn(a, b):
        return ((a + b) * b) - a

    a, b = _ints(0, -60, 60, 70), _ints(1, -60, 60, 70)
    lf = lower(fn, spec=TSpec(**SMALL) if banked else None)
    comp = lf.trace(a, b)
    assert len(comp.regions) == 1
    TLEDGER.reset()
    out1 = lf(a, b)
    cold = _ledger()
    mid = tdisp.cache_stats()
    TLEDGER.reset()
    out2 = lf(a, b)
    after = tdisp.cache_stats()
    assert _ledger() == cold
    assert after["dispatches"] - mid["dispatches"] == 1
    assert after["misses"] == mid["misses"]
    assert torch.equal(out1, fn(a, b)) and torch.equal(out1, out2)


def test_structurally_identical_regions_share_one_program():
    def make():
        return lower(lambda a, b: (a + b) ^ a)

    a, b = _ints(2, -40, 40, 34), _ints(3, -40, 40, 34)
    want = (a + b) ^ a
    assert torch.equal(make()(a, b), want)
    before = tdisp.cache_stats()
    assert torch.equal(make()(a, b), want)
    after = tdisp.cache_stats()
    assert after["misses"] == before["misses"]
    assert after["hits"] > before["hits"]


def test_identical_regions_within_one_trace_compile_once():
    def fn(a, b):
        t = (a + b) ^ a
        q = torch.floor(t.float() / 2.0).to(torch.int16)
        return (q + b) ^ q

    a, b = _ints(4, -40, 40, 38), _ints(5, -40, 40, 38)
    lf = lower(fn)
    comp = lf.trace(a, b)
    assert len(comp.regions) == 2
    assert comp.regions[0].key == comp.regions[1].key
    before = tdisp.cache_stats()
    out = lf(a, b)
    after = tdisp.cache_stats()
    assert after["misses"] - before["misses"] == 1
    assert after["dispatches"] - before["dispatches"] == 2
    assert torch.equal(out, fn(a, b))


def test_dead_region_inputs_exclude_the_callers_tensors():
    """The reference's donation case: a region eating the caller's x
    directly never names it, and a duplicated output stays live."""
    def g(x):
        t = x + 1
        return t, t

    def fn(x):
        a, b = g(x)
        return a * 2, b

    x = torch.arange(-8, 8, dtype=torch.int16)
    comp = lower(fn).trace(x)
    (region,) = comp.regions
    assert region.donatable == ()
    _assert_equal(lower(fn)(x), fn(x))


def test_dead_region_inputs_mark_host_intermediates(ref_lowering):
    """Positive control, equal to the reference's index set: a host
    intermediate consumed only by the region is dead after it, and the
    interpreter drops it."""
    def tfn(x):
        h = torch.sin(x.float())
        q = torch.round(h * 7.0).to(torch.int16)
        return q * 2

    def jfn(x):
        h = jnp.sin(x.astype(jnp.float32))
        return jnp.round(h * 7.0).astype(jnp.int16) * 2

    x = np.arange(-8, 8, dtype=np.int16)
    comp = lower(tfn).trace(_t(x))
    rcomp = rlower(jfn, backend="jnp-boolean").trace(x)
    (region,), (rregion,) = comp.regions, rcomp.regions
    assert region.donatable == rregion.donatable == (0,)
    dead = region.in_atoms[0]
    seen = {}
    run_region = comp._run_region

    def spy(region_, env, device, resident_map=None):
        run_region(region_, env, device, resident_map)
        seen["alive"] = dead in env

    comp._run_region = spy
    assert torch.equal(comp.execute(_t(x)), tfn(_t(x)))
    assert seen == {"alive": False}


def test_host_values_are_dropped_after_their_last_reader():
    """Every value a host op produces that the function does not return is
    dropped from the interpreter's env exactly once, after its last
    reader, as an eager run frees its temporaries: a full-width weight's
    quantization temporaries must not all live until the call returns."""
    def fn(x, w):
        return tlayers._quantized_linear(x, w, 8)

    gen = torch.Generator().manual_seed(3)
    x, w = torch.randn((2, 1, 8), generator=gen), torch.randn(
        (8, 4), generator=gen)
    comp = lower(fn).trace(x, w)
    outs = {v for v in comp.trace.outvars}
    order = {}
    for i, (kind, payload) in enumerate(comp.items):
        for op in (payload.ops if kind == "region" else [payload]):
            for a in op.invars:
                order[a] = i
    # each item's drops: a host item's dead values, a region's dead inputs
    drops = [dead if kind == "host" else tuple(
        payload.in_atoms[j] for j in payload.donatable)
        for dead, (kind, payload) in zip(comp._host_dead, comp.items)]
    dropped = [v for dead in drops for v in dead]
    assert len(dropped) == len(set(dropped))
    for i, (kind, payload) in enumerate(comp.items):
        if kind != "host":
            continue
        for v in payload.outvars:
            if v in outs:
                assert v not in dropped
                continue
            at = next(j for j, dead in enumerate(drops) if v in dead)
            assert at == max(order.get(v, i), i)
    assert torch.equal(comp.execute(x, w), fn(x, w))


# ---------------------------------------------------------------------------
# attention on the array
# ---------------------------------------------------------------------------


def _qkv(seed, b=2, tq=2, tk=8, hq=4, hkv=2, d=8, dv=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, tq, hq, d)).astype(np.float32),
            rng.normal(size=(b, tk, hkv, d)).astype(np.float32),
            rng.normal(size=(b, tk, hkv, dv)).astype(np.float32))


def _causal(b, tq, tk):
    m = np.arange(tq)[:, None] + (tk - tq) >= np.arange(tk)[None, :]
    return np.broadcast_to(m[None], (b, tq, tk)).copy()


def test_sdpa_cim_bit_exact_vs_host_and_close_to_reference(ref_lowering):
    q, k, v = _qkv(0)
    mask = _causal(2, 2, 8)
    scale = 1.0 / q.shape[-1] ** 0.5
    args = [_t(a) for a in (q, k, v, mask)]
    host = tattn._sdpa_quantized(*args, scale)
    lowered = tattn.sdpa_cim(*args, scale)
    assert torch.equal(lowered, host)
    ref = rattn.sdpa_cim(*(jnp.asarray(a) for a in (q, k, v, mask)), scale,
                         backend="jnp-boolean")
    np.testing.assert_allclose(lowered.numpy(), np.asarray(ref), **F32_TOL)
    assert TLEDGER.accesses == RLEDGER.accesses
    assert TLEDGER.load_words32 == RLEDGER.load_words32


def test_sdpa_cim_warm_dispatches_exactly_two():
    args = [_t(a) for a in _qkv(1)] + [_t(_causal(2, 2, 8))]
    tattn.sdpa_cim(*args, 0.35)
    before = tdisp.cache_stats()
    tattn.sdpa_cim(*args, 0.35)
    after = tdisp.cache_stats()
    assert after["misses"] == before["misses"]
    assert after["dispatches"] - before["dispatches"] == 2


def test_sdpa_cim_resident_kv_hits_on_stable_cache():
    q1, k, v = (_t(a) for a in _qkv(2))
    q2 = q1 + 1.0
    mask = _t(_causal(2, 2, 8))
    tattn.sdpa_cim(q1, k, v, mask, 0.35, resident=True)
    before = tdisp.cache_stats()
    out = tattn.sdpa_cim(q2, k, v, mask, 0.35, resident=True)
    after = tdisp.cache_stats()
    assert after["resident_hits"] > before["resident_hits"]
    assert after["resident_pins"] == before["resident_pins"]
    assert torch.equal(out, tattn._sdpa_quantized(q2, k, v, mask, 0.35))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bk", [4, 8, 16, 12])
def test_blockwise_cim_bit_exact(bk, causal):
    """Bit-exact with the quantized host form across block sizes, one of
    which does not divide the kv length (the padding path)."""
    q, k, v = (_t(a) for a in _qkv(bk + causal, b=1, tq=4, tk=16, hq=2,
                                   hkv=1, d=4, dv=4))
    host = tblock.blockwise_attention_quantized(q, k, v, causal=causal,
                                                block_k=bk)
    low = tblock.blockwise_attention_cim(q, k, v, causal=causal, block_k=bk)
    assert torch.equal(low, host)


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_quantized_matches_reference(causal):
    q, k, v = _qkv(6, b=1, tq=4, tk=16, hq=2, hkv=1, d=4, dv=4)
    t = tblock.blockwise_attention_quantized(_t(q), _t(k), _t(v),
                                             causal=causal, block_k=12)
    r = rblock.blockwise_attention_quantized(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_k=12)
    np.testing.assert_allclose(t.numpy(), np.asarray(r), **F32_TOL)


def test_blockwise_cim_structural_cache_shared_across_blocks():
    q, k, v = (_t(a) for a in _qkv(3, b=1, tq=4, tk=32, hq=2, hkv=1, d=4,
                                   dv=4))
    tblock.blockwise_attention_cim(q, k, v, block_k=8)
    stats = tdisp.cache_stats()
    before = stats["misses"], stats["dispatches"]
    tblock.blockwise_attention_cim(q, k, v, block_k=8)
    stats = tdisp.cache_stats()
    assert stats["misses"] == before[0]
    assert stats["dispatches"] - before[1] == 2 * 4
    q2, k2, v2 = (_t(a) for a in _qkv(4, b=1, tq=4, tk=16, hq=2, hkv=1,
                                      d=4, dv=4))
    tblock.blockwise_attention_cim(q2, k2, v2, block_k=8)
    assert tdisp.cache_stats()["misses"] == before[0]


def test_blockwise_quantized_close_to_float():
    q, k, v = (_t(a) for a in _qkv(5, b=1, tq=8, tk=8, hq=2, hkv=2, d=8,
                                   dv=8))
    ref = tblock.blockwise_attention(q, k, v, True, None, 0, 8)
    got = tblock.blockwise_attention_quantized(q, k, v, causal=True,
                                               block_k=8)
    np.testing.assert_allclose(got.numpy(), ref.detach().numpy(), atol=0.08,
                               rtol=0.0)


def test_gqa_decode_cim_two_dispatches_per_step_and_close_to_float():
    from repro_torch.configs.base import ArchConfig

    cfg = ArchConfig(name="t", family="dense", n_layers=1, d_model=16,
                     n_heads=4, n_kv_heads=2, head_dim=8, d_ff=32,
                     vocab_size=64, dtype="float32", tensor_parallel=False,
                     cim_attention_bits=8)
    gen = torch.Generator().manual_seed(2)
    p = tattn.gqa_init(gen, cfg, torch.float32, "cpu")
    cache = tattn.gqa_make_cache(cfg, 2, 8, torch.float32, "cpu")
    x = torch.randn((2, 1, 16), generator=gen)
    positions = torch.tensor([3, 5])
    y_ref, c_ref = tattn.gqa_decode(p, cfg, x, cache, positions)
    tattn.gqa_decode_cim(p, cfg, x, cache, positions)
    before = tdisp.cache_stats()["dispatches"]
    y_cim, c_cim = tattn.gqa_decode_cim(p, cfg, x, cache, positions)
    assert tdisp.cache_stats()["dispatches"] - before == 2
    assert torch.equal(c_cim["k"], c_ref["k"])
    assert torch.equal(c_cim["v"], c_ref["v"])
    np.testing.assert_allclose(y_cim.numpy(), y_ref.numpy(), atol=0.05,
                               rtol=0.0)
