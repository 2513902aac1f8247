"""Port vs reference: the offload estimator (`core/offload.py`).

The `analyze` halves of `tests/test_cim_lower.py`'s estimator cases (random
graphs, banked, the HLO source, s4 accounting), `tests/test_cim_cost.py`'s
`test_projected_words_match_estimator_accounting` and
`test_demotion_visible_in_offload_report`, `analyze_hlo` at
`tests/test_cim_array.py:337` and `tests/test_cim_macro.py:392`, and
`analyze_trace` at `tests/test_cim_batched.py:203`. On twin functions
(written once in jnp, once in torch with explicit dtypes, as
`tests/test_torch_cost.py` writes them) every count, histogram and
projection of the report equals the reference's; on HLO text, the same
text goes to both parsers. The estimator equals the port's own executed
ledger. `analyze(source="hlo")` compiles through XLA in the reference; the
port has none and raises, naming `analyze_hlo`. The reference's capture
needs the `jax.core.Literal`/`Var` aliases under JAX 0.9, applied per test.
"""
import jax
import jax.extend.core as jex
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cim import planner as rplanner
from repro.cim.array import ArraySpec as RSpec
from repro.cim.trace import trace as rtrace
from repro.core import offload as roff
from repro_torch.cim import dispatch as tdisp
from repro_torch.cim import planner as tplanner
from repro_torch.cim.accounting import LEDGER
from repro_torch.cim.array import ArraySpec as TSpec
from repro_torch.cim.cost import plan_offload
from repro_torch.cim.lower import lower
from repro_torch.cim.trace import int_contract, trace
from repro_torch.core import offload as toff
from repro_torch.core.offload import analyze, analyze_hlo, analyze_trace

SMALL = dict(banks=2, subarrays=1, rows=128, bitline_words=32)
SLIVER = dict(banks=2, subarrays=1, rows=1024, bitline_words=32)
#: every count of the report (the floats are compared to 1e-12 relative)
_COUNTS = ("eligible_ops", "eligible_bytes", "total_bytes_estimate",
           "words32", "multi_access_ops",
           "planner_accesses", "banked_accesses", "bank_waves",
           "adra_accesses", "stream_load_accesses",
           "resident_savable_accesses", "source", "policy", "demoted_eqns",
           "demoted_accesses", "fused_losses", "op_histogram")


@pytest.fixture(autouse=True)
def _fresh_state():
    LEDGER.reset()
    tdisp.clear_schedule_cache()
    yield
    LEDGER.reset()
    tdisp.clear_schedule_cache()


@pytest.fixture
def ref_capture(monkeypatch):
    """The reference's jaxpr capture under JAX 0.9, for this test only."""
    monkeypatch.setattr(jax.core, "Literal", jex.Literal, raising=False)
    monkeypatch.setattr(jax.core, "Var", jex.Var, raising=False)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _same_report(got, want):
    for f in _COUNTS:
        assert getattr(got, f) == getattr(want, f), (f, getattr(got, f),
                                                     getattr(want, f))
    for f in ("edp_decrease_pct", "energy_saved_fj"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12)


# ---------------------------------------------------------------------------
# twin functions: the report equals the reference's
# ---------------------------------------------------------------------------


def _twin_cases():
    """(name, jnp fn, torch fn, numpy args, spec kwargs or None, policy)."""
    rng = np.random.RandomState(0)
    a16 = np.arange(-64, 64, dtype=np.int16)
    b16 = (5 - a16).astype(np.int16)
    sliver = np.array([3, -9, 5, 7], np.int16)
    x8 = rng.randint(-128, 128, (4, 12)).astype(np.int8)
    w8 = rng.randint(-128, 128, (12, 6)).astype(np.int8)
    qb = rng.randint(-128, 128, (2, 3, 5)).astype(np.int8)
    kb = rng.randint(-128, 128, (2, 5, 4)).astype(np.int8)

    def j_mix(a, b):
        t = (a + b) * b
        return jax.lax.select(t < a, t, a), jnp.sum(t)

    def t_mix(a, b):
        t = (a + b) * b
        return torch.where(t < a, t, a), \
            torch.sum(t.to(torch.int32), dtype=torch.int32)

    def j_words(a, b):
        return (a + b) * b, jnp.sum(a)

    def t_words(a, b):
        return (a + b) * b, torch.sum(a.to(torch.int32), dtype=torch.int32)

    def j_mm(x, w):
        return jnp.matmul(x, w, preferred_element_type=jnp.int32) + 1

    def t_mm(x, w):
        return int_contract(x, w) + 1

    def j_bmm(q, k):
        return jax.lax.dot_general(q, k, (((2,), (1,)), ((0,), (0,))),
                                   preferred_element_type=jnp.int32)

    def j_pop(a):
        return jax.lax.population_count(a) ^ a

    def t_pop(a):
        return torch.ops.repro_torch.population_count(a) ^ a

    return [
        ("mix", j_mix, t_mix, (a16, b16), None, "always"),
        ("mix banked", j_mix, t_mix, (a16, b16), SMALL, "always"),
        ("mix banked edp", j_mix, t_mix, (a16, b16), SMALL, "edp"),
        ("words", j_words, t_words, (a16, a16), None, "always"),
        ("sliver edp", lambda a, b: a + b, lambda a, b: a + b,
         (sliver, (5 - sliver).astype(np.int16)), SLIVER, "edp"),
        ("matmul", j_mm, t_mm, (x8, w8), SMALL, "always"),
        ("batched matmul", j_bmm, int_contract, (qb, kb), None, "always"),
        ("popcount", j_pop, t_pop, (a16,), None, "always"),
    ]


@pytest.mark.parametrize("case", range(8))
def test_report_matches_reference(ref_capture, case):
    name, jfn, tfn, args, spec_kw, policy = _twin_cases()[case]
    rspec = RSpec(**spec_kw) if spec_kw else None
    tspec = TSpec(**spec_kw) if spec_kw else None
    want = roff.analyze(jfn, *(jnp.asarray(a) for a in args), spec=rspec,
                        policy=policy)
    got = analyze(tfn, *(_t(a) for a in args), spec=tspec, policy=policy)
    _same_report(got, want)
    assert len(got.eqn_verdicts) == len(want.eqn_verdicts), name
    assert got.bank_parallel_speedup == want.bank_parallel_speedup
    # the executor agrees: one lowered call charges what was projected
    LEDGER.reset()
    lower(tfn, spec=tspec, policy=policy)(*(_t(a) for a in args))
    assert LEDGER.accesses == (got.banked_accesses if spec_kw
                               else got.adra_accesses), name


# ---------------------------------------------------------------------------
# tests/test_cim_lower.py: estimator == executor
# ---------------------------------------------------------------------------


def _edge_operand(dtype, n_words, seed):
    info = np.iinfo(dtype)
    rng = np.random.RandomState(seed)
    edges = np.array([info.min, info.max, 0, 1, info.min + 1, info.max - 1],
                     np.int64)
    vals = np.concatenate([edges, rng.randint(
        int(info.min), int(info.max) + 1, max(0, n_words - len(edges)),
        dtype=np.int64)])[:n_words]
    rng.shuffle(vals)
    return _t(vals.astype(dtype))


def _random_fn(steps):
    """A composed graph over the eligible surface plus a float island."""
    def fn(a, b, c):
        vals = [a, b, c]
        for kind, sel in steps:
            x = vals[sel % len(vals)]
            y = vals[(sel // 7) % len(vals)].to(x.dtype)
            k = kind % 10
            if k == 0:
                out = x + y
            elif k == 1:
                out = x - y
            elif k == 2:
                out = x * y
            elif k == 3:
                out = (x & y) ^ (x | y)
            elif k == 4:
                out = torch.minimum(x, y) - torch.maximum(x, y)
            elif k == 5:
                out = torch.where(x <= y, -x, ~y)
            elif k == 6:
                out = torch.abs(x)
            elif k == 7:
                out = torch.floor(x.float() / 3.0).to(x.dtype)
            elif k == 8:
                out = x.to(torch.int32) + torch.sum(x.to(torch.int32),
                                                    dtype=torch.int32)
            else:
                out = x.to(torch.int8).to(x.dtype)
            vals.append(out)
        return tuple(vals[-3:])

    return fn


@pytest.mark.parametrize("seed", range(8))
def test_lowered_ledger_always_equals_plan(seed):
    """For random graphs, one execution charges the ledger exactly the
    planned access count, and the estimator reports the same number."""
    rng = np.random.RandomState(seed)
    dtype = (np.int8, np.int16, np.int32)[seed % 3]
    steps = [(int(rng.randint(0, 10)), int(rng.randint(0, 10_000)))
             for _ in range(4)]
    fn = _random_fn(steps)
    args = [_edge_operand(dtype, 12, seed + i) for i in range(3)]
    lf = lower(fn)
    comp = lf.trace(*args)
    LEDGER.reset()
    lf(*args)
    assert LEDGER.accesses == comp.accesses
    assert analyze(fn, *args).adra_accesses == LEDGER.accesses


def test_offload_counts_equal_executed_ledger_banked():
    def fn(a, b):
        t = (a + b) * b
        p = t < a
        return torch.where(p, t, a), torch.sum(t.to(torch.int32),
                                               dtype=torch.int32)

    a = torch.arange(-64, 64, dtype=torch.int16)
    b = 5 - a
    spec = TSpec(**SMALL)
    rep = analyze(fn, a, b)
    LEDGER.reset()
    for g, w in zip(lower(fn)(a, b), fn(a, b)):
        assert torch.equal(g, w)
    assert LEDGER.accesses == rep.adra_accesses
    rep_banked = analyze(fn, a, b, spec=spec)
    assert rep_banked.banked_accesses > rep_banked.adra_accesses  # >1 tile
    LEDGER.reset()
    for g, w in zip(lower(fn, spec=spec)(a, b), fn(a, b)):
        assert torch.equal(g, w)
    assert LEDGER.accesses == rep_banked.banked_accesses


def test_offload_hlo_source_raises_and_names_analyze_hlo():
    """The reference compiles through XLA for source="hlo"; the port has no
    XLA, so it raises and names the way in for HLO text; the same function's
    HLO text (compiled by the reference) then gives the reference's report."""
    def tfn(a, b):
        return (a + b) * b

    a = torch.arange(16, dtype=torch.int16)
    with pytest.raises(NotImplementedError, match="analyze_hlo"):
        analyze(tfn, a, a, source="hlo")
    with pytest.raises(ValueError):
        analyze(tfn, a, a, source="nope")
    ja = jnp.arange(16, dtype=jnp.int16)
    want = roff.analyze(tfn, ja, ja, source="hlo")
    hlo = jax.jit(tfn).lower(ja, ja).as_text("hlo")
    got = analyze_hlo(hlo)
    assert got.source == "hlo"
    assert got.op_histogram.get("add") == 1
    assert got.op_histogram.get("multiply") == 1
    _same_report(got, want)


def test_offload_s4_bit_accounting_rounds_once():
    """4-bit dtypes contribute exact bit counts, rounded to bytes once."""
    text = "%x = s4[101]{0} add(s4[101] %a, s4[101] %b)\n"
    r = analyze_hlo(text)
    # 3 * 101 * 4 bits = 1212 bits -> ceil = 152 bytes (not int(151.5))
    assert r.eligible_bytes == 152
    assert isinstance(r.eligible_bytes, int)
    assert r.total_bytes_estimate >= r.eligible_bytes
    _same_report(r, roff.analyze_hlo(text))


# ---------------------------------------------------------------------------
# tests/test_cim_cost.py: the report reads the cost model's plan
# ---------------------------------------------------------------------------


def test_projected_words_match_estimator_accounting():
    def fn(a, b):
        return (a + b) * b, torch.sum(a.to(torch.int32), dtype=torch.int32)

    a = torch.arange(-32, 32, dtype=torch.int16)
    plan = plan_offload(trace(fn, a, a), policy="always")
    rep = analyze(fn, a, a)
    assert rep.eqn_verdicts == plan.verdicts
    assert sum(v.words32 for v in plan.verdicts) > 0
    assert rep.adra_accesses == sum(v.accesses for v in plan.verdicts)


def test_demotion_visible_in_offload_report():
    def fn(a, b):
        return a + b

    a = torch.tensor([3, -9, 5, 7], dtype=torch.int16)
    b = 5 - a
    rep = analyze(fn, a, b, spec=TSpec(**SLIVER), policy="edp")
    assert rep.policy == "edp"
    assert rep.demoted_eqns == 1
    assert rep.demoted_accesses == 1
    assert any(not v.lowers for v in rep.eqn_verdicts)
    # the report's historical default remains the un-demoted projection
    rep_always = analyze(fn, a, b, spec=TSpec(**SLIVER))
    assert rep_always.policy == "always" and rep_always.demoted_eqns == 0


# ---------------------------------------------------------------------------
# analyze_hlo (tests/test_cim_array.py:337, tests/test_cim_macro.py:392)
# ---------------------------------------------------------------------------


def test_offload_bank_aware_access_counts():
    hlo = ("  %r = s8[4096] add(s8[4096] %a, s8[4096] %b)\n"
           "  %m = s8[4096] multiply(s8[4096] %a, s8[4096] %b)\n")
    base = analyze_hlo(hlo)
    assert base.banked_accesses == 0 and base.bank_waves == 0
    kw = dict(banks=4, subarrays=1, rows=1024, bitline_words=1024)
    rep = analyze_hlo(hlo, spec=TSpec(**kw))
    # 4096 words -> 4 tiles -> 1 wave on 4 banks; multiply plans 15 accesses
    assert rep.banked_accesses == (1 + 15) * 4
    assert rep.bank_waves == (1 + 15) * 1
    assert rep.bank_parallel_speedup == pytest.approx(4.0)
    _same_report(rep, roff.analyze_hlo(hlo, spec=RSpec(**kw)))


def test_offload_counts_multiply_and_dot_with_planner_accesses():
    hlo = """
      %m = s8[64,128]{1,0} multiply(s8[64,128]{1,0} %a, s8[64,128]{1,0} %b)
      %d = s32[64,16]{1,0} dot(s8[64,32]{1,0} %x, s8[32,16]{1,0} %y), lhs_contracting_dims={1}, rhs_contracting_dims={0}
      %s = s8[64,128]{1,0} add(s8[64,128]{1,0} %a, s8[64,128]{1,0} %b)
      ROOT %c = pred[64,128]{1,0} compare(s8[64,128]{1,0} %a, s8[64,128]{1,0} %b), direction=LT
      %u = u4[7]{0} maximum(u4[7]{0} %p, u4[7]{0} %q)
    """
    r = analyze_hlo(hlo)
    assert r.op_histogram == {"multiply": 1, "dot": 1, "add": 1,
                              "compare": 1, "maximum": 1}
    assert r.multi_access_ops == 2
    want = tplanner.plan_multiply(8, 8).accesses + \
        tplanner.plan_matmul(32, 1, n_bits=8).accesses
    assert want == rplanner.plan_multiply(8, 8).accesses + \
        rplanner.plan_matmul(32, 1, n_bits=8).accesses
    assert r.planner_accesses == want
    assert r.eligible_ops == 5 and r.edp_decrease_pct > 0
    assert 0 < r.eligible_fraction <= 1
    _same_report(r, roff.analyze_hlo(hlo))


# ---------------------------------------------------------------------------
# analyze_trace (tests/test_cim_batched.py:203)
# ---------------------------------------------------------------------------


def test_offload_reports_batched_dot_category(ref_capture):
    rng = np.random.RandomState(8)
    a = rng.randint(-128, 128, (2, 3, 5)).astype(np.int8)
    b = rng.randint(-128, 128, (2, 5, 4)).astype(np.int8)
    rep = analyze_trace(trace(int_contract, _t(a), _t(b)))
    assert rep.op_histogram == {"batched_dot": 1}
    assert rep.multi_access_ops == 1
    # the rhs (KV side under attention) is pinnable: one savable load
    assert rep.resident_savable_accesses == 1
    assert rep.adra_accesses == \
        tplanner.plan_batched_matmul(2, 5, 4).accesses
    want = roff.analyze_trace(rtrace(
        lambda x, y: jax.lax.dot_general(
            x, y, (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.int32),
        jnp.asarray(a), jnp.asarray(b)))
    _same_report(rep, want)


def test_core_exports_match_reference():
    import repro.core as rcore
    import repro_torch.core as tcore

    exported = {n for n in dir(rcore) if not n.startswith("_")}
    submodules = {"adra", "array", "bitplane", "compute_module", "energy",
                  "fefet", "offload", "sensing"}
    for name in exported - submodules:
        assert hasattr(tcore, name), name
    assert toff.OffloadReport is tcore.OffloadReport
