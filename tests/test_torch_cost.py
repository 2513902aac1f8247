"""Port vs reference: the cost model (`cim/cost.py`) and the energy model's
sweeps and anchors (`core/energy.py`).

The same functions, written once in jnp and once in torch with explicit
dtypes so both captures hold the same ops in the same order, go through
both packages' `plan_offload`: every verdict field equal (floats within
1e-9 relative) under "edp", "always", "never" and "latency", unbanked and
banked, with the reference's own device row (a v5e) built from its dict.
The port's default row is an H100; under "edp" the row does not enter the
decision. Through `lower()`, the policies keep results bit-exact and the
projected banked accesses and waves equal the executed ledger. The
reference's capture needs the `jax.core.Literal`/`Var` aliases under JAX
0.9, applied per test. Autotune (ROADMAP A6) is not ported yet.
"""
import dataclasses

import jax
import jax.extend.core as jex
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cim import cost as rcost
from repro.cim import dispatch as rdisp
from repro.cim.array import ArraySpec as RSpec
from repro.cim.trace import trace as rtrace
from repro.core import energy as renergy
from repro_torch.cim import cost as tcost
from repro_torch.cim import dispatch as tdisp
from repro_torch.cim import planner as tplan
from repro_torch.cim.accounting import LEDGER as TLEDGER
from repro_torch.cim.array import ArraySpec as TSpec
from repro_torch.cim.lower import lower
from repro_torch.cim.trace import int_contract
from repro_torch.cim.trace import trace as ttrace
from repro_torch.core import energy as tenergy


@pytest.fixture(autouse=True)
def _fresh_state():
    TLEDGER.reset()
    tdisp.clear_schedule_cache()
    yield
    TLEDGER.reset()
    tdisp.clear_schedule_cache()
    rdisp.clear_schedule_cache()


@pytest.fixture
def ref_capture(monkeypatch):
    """The reference's jaxpr capture under JAX 0.9, for this test only."""
    monkeypatch.setattr(jax.core, "Literal", jex.Literal, raising=False)
    monkeypatch.setattr(jax.core, "Var", jex.Var, raising=False)


def _specs(**kw):
    return RSpec(**kw), TSpec(**kw)


SLIVER = dict(banks=2, subarrays=1, rows=1024, bitline_words=32)
SMALL = dict(banks=2, subarrays=1, rows=128, bitline_words=32)
V5E = tcost.DeviceSpec.from_dict(rcost.DEFAULT_DEVICE.to_dict())


def _torch(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_equal(got, want):
    got_l = got if isinstance(got, (tuple, list)) else (got,)
    want_l = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------------------------
# DeviceSpec and policies
# ---------------------------------------------------------------------------


def test_device_spec_defaults_and_dict_roundtrip():
    d = tcost.DEFAULT_DEVICE
    assert (d.name, d.peak_flops, d.hbm_bw, d.ici_bw) == \
        ("h100-sxm", 989e12, 3.35e12, 450e9)
    # the energy-model parameters stay the reference's
    assert (d.pj_per_flop, d.pj_per_byte) == \
        (rcost.DEFAULT_DEVICE.pj_per_flop, rcost.DEFAULT_DEVICE.pj_per_byte)
    lab = tcost.DeviceSpec(name="lab-chip", peak_flops=1e12, hbm_bw=1e11,
                           ici_bw=1e10, pj_per_flop=0.7, pj_per_byte=15.0)
    assert tcost.DeviceSpec.from_dict(lab.to_dict()) == lab
    assert lab.key == tuple(lab.to_dict().values())
    assert V5E.to_dict() == rcost.DEFAULT_DEVICE.to_dict()
    assert V5E.key == rcost.DEFAULT_DEVICE.key
    with pytest.raises(ValueError):
        tcost.DeviceSpec.from_dict({"name": "x", "warp_drive": 9000})


def test_device_spec_csv_roundtrip(tmp_path):
    path = tmp_path / "devices.csv"
    path.write_text(
        "name,peak_flops,hbm_bw,ici_bw,pj_per_flop,pj_per_byte\n"
        "h100-sxm,989e12,3.35e12,450e9,0.5,20.0\n"
        "tpu-v5e,197e12,819e9,50e9,0.5,20.0\n")
    assert tcost.DeviceSpec.from_csv(str(path)) == tcost.DEFAULT_DEVICE
    assert tcost.DeviceSpec.from_csv(str(path), name="tpu-v5e") == V5E
    assert rcost.DeviceSpec.from_csv(str(path), name="tpu-v5e") == \
        rcost.DEFAULT_DEVICE
    with pytest.raises(ValueError):
        tcost.DeviceSpec.from_csv(str(path), name="nope")
    (tmp_path / "empty.csv").write_text("name\n")
    with pytest.raises(ValueError):
        tcost.DeviceSpec.from_csv(str(tmp_path / "empty.csv"))


@pytest.mark.parametrize("policy", [None, "cost", "always", "edp",
                                    "latency", "never", "yolo"])
def test_normalize_policy_matches_reference(policy):
    if policy == "yolo":
        for mod in (tcost, rcost):
            with pytest.raises(ValueError):
                mod.normalize_policy(policy)
        return
    assert tcost.normalize_policy(policy) == rcost.normalize_policy(policy)
    assert tcost.POLICIES == rcost.POLICIES
    assert tcost.DEFAULT_POLICY == rcost.DEFAULT_POLICY


@pytest.mark.parametrize("n_bits", [1, 4, 8, 16, 32])
def test_ecc_overhead_matches_reference(n_bits):
    assert tcost.ecc_overhead(n_bits) == rcost.ecc_overhead(n_bits)


# ---------------------------------------------------------------------------
# verdict parity on twin functions
# ---------------------------------------------------------------------------


def _twin_cases():
    """(name, jnp fn, torch fn, numpy args, spec kwargs or None)."""
    rng = np.random.RandomState(0)
    a16 = np.arange(-64, 64, dtype=np.int16)
    b16 = (5 - a16).astype(np.int16)
    sliver = np.array([3, -9, 5, 7], np.int16)
    big = np.arange(4096, dtype=np.int16)
    x8 = rng.randint(-128, 128, (16, 64)).astype(np.int8)
    w8 = rng.randint(-128, 128, (64, 64)).astype(np.int8)
    qb = rng.randint(-128, 128, (2, 3, 8, 16)).astype(np.int8)
    kb = rng.randint(-128, 128, (2, 3, 16, 5)).astype(np.int8)

    def j_mix(a, b):
        t = (a + b) * b
        return jax.lax.select(t < a, t, a), jnp.sum(t)

    def t_mix(a, b):
        t = (a + b) * b
        return torch.where(t < a, t, a), \
            torch.sum(t.to(torch.int32), dtype=torch.int32)

    def j_sandwich(a, s):
        return s * s, (a + a) ^ a

    def t_sandwich(a, s):
        return s * s, (a + a) ^ a

    def j_fused(a, s):
        t = a + a
        u = s * s
        return u, t ^ a

    def t_fused(a, s):
        t = a + a
        u = s * s
        return u, t ^ a

    def j_split(a, s):
        return a + a, s * s, a ^ a

    t_split = j_split

    def j_mm(x, w):
        return jnp.matmul(x, w, preferred_element_type=jnp.int32) + 1

    def t_mm(x, w):
        return int_contract(x, w) + 1

    def j_bmm(q, k):
        return jax.lax.dot_general(q, k, (((3,), (2,)), ((0, 1), (0, 1))),
                                   preferred_element_type=jnp.int32)

    return [
        ("mix", j_mix, t_mix, (a16, b16), SMALL),
        ("mix unbanked", j_mix, t_mix, (a16, b16), None),
        ("sliver", lambda a, b: a + b, lambda a, b: a + b,
         (sliver, (5 - sliver).astype(np.int16)), SLIVER),
        ("interior loser fused", j_fused, t_fused, (big, sliver), SLIVER),
        ("interior loser split", j_split, t_split, (big, sliver), SLIVER),
        ("sandwich edges", j_sandwich, t_sandwich, (big, sliver), SLIVER),
        ("matmul banked", j_mm, t_mm, (x8, w8),
         dict(banks=4, subarrays=4, rows=1024, bitline_words=256)),
        ("batched matmul", j_bmm, int_contract, (qb, kb), None),
    ]


_VERDICT_FLOATS = ("words32", "activated_words32", "load_words32",
                   "inter_bank_words32", "cim_energy", "cim_latency",
                   "base_energy", "base_latency", "host_time_s",
                   "host_energy_j", "margin")


def _same_verdicts(rplan, tplan_):
    assert tplan_.policy == rplan.policy
    assert tplan_.demoted == rplan.demoted
    assert tplan_.fused_losses == rplan.fused_losses
    assert len(tplan_.verdicts) == len(rplan.verdicts)
    for rv, tv in zip(rplan.verdicts, tplan_.verdicts):
        for f in dataclasses.fields(rv):
            r, t = getattr(rv, f.name), getattr(tv, f.name)
            if f.name in _VERDICT_FLOATS:
                assert t == pytest.approx(r, rel=1e-9, abs=1e-30), f.name
            else:
                assert t == r, (f.name, t, r)


@pytest.mark.parametrize("policy", ["edp", "always", "never", "latency"])
@pytest.mark.parametrize("case", range(8))
def test_verdicts_match_reference(ref_capture, case, policy):
    """Every verdict field equal to the reference's on the same function,
    spec and device row (the reference's v5e)."""
    name, jfn, tfn, args, spec_kw = _twin_cases()[case]
    rspec, tspec = _specs(**spec_kw) if spec_kw else (None, None)
    rp = rcost.plan_offload(rtrace(jfn, *(jnp.asarray(a) for a in args)),
                            spec=rspec, policy=policy)
    tp = tcost.plan_offload(ttrace(tfn, *(_torch(a) for a in args)),
                            spec=tspec, policy=policy, device=V5E)
    _same_verdicts(rp, tp)


@pytest.mark.parametrize("case", range(8))
def test_edp_decision_does_not_depend_on_the_device_row(case):
    _, _, tfn, args, spec_kw = _twin_cases()[case]
    tr = ttrace(tfn, *(_torch(a) for a in args))
    spec = TSpec(**spec_kw) if spec_kw else None
    h100 = tcost.plan_offload(tr, spec=spec, policy="edp")
    v5e = tcost.plan_offload(tr, spec=spec, policy="edp", device=V5E)
    assert h100.device.name == "h100-sxm"
    assert h100.demoted == v5e.demoted
    assert [(v.lowers, v.fused, v.margin) for v in h100.verdicts] == \
        [(v.lowers, v.fused, v.margin) for v in v5e.verdicts]


def test_plan_stats_count_like_the_reference(ref_capture):
    _, jfn, tfn, args, spec_kw = _twin_cases()[3]
    rspec, tspec = _specs(**spec_kw)
    rcost.reset_plan_stats()
    tcost.reset_plan_stats()
    for policy in ("edp", "never", "always"):
        rcost.plan_offload(rtrace(jfn, *(jnp.asarray(a) for a in args)),
                           spec=rspec, policy=policy)
        tcost.plan_offload(ttrace(tfn, *(_torch(a) for a in args)),
                           spec=tspec, policy=policy)
    assert tcost.PLAN_STATS == rcost.PLAN_STATS
    assert tcost.PLAN_STATS["plans"] == 3
    tcost.reset_plan_stats()
    assert set(tcost.PLAN_STATS.values()) == {0}


# ---------------------------------------------------------------------------
# projection == execution on random banked graphs
# ---------------------------------------------------------------------------

#: <= 16-bit dtypes: the spec has 128 rows and a mul's 2n-bit product
#: planes must fit them
DTYPES = ("int8", "int16", "uint8", "uint16")
#: the dtype jnp's sum promotes to, which the torch twin names explicitly
_SUM_DTYPE = {"int8": "int32", "int16": "int32", "uint8": "uint32",
              "uint16": "uint32"}
_N_STEP_KINDS = 8


def _steps(seed, n):
    rng = np.random.RandomState(seed)
    return [(int(rng.randint(0, _N_STEP_KINDS)), int(rng.randint(0, 10_000)))
            for _ in range(n)]


def _jnp_graph(steps):
    def fn(a, b):
        vals = [a, b]
        for kind, sel in steps:
            x = vals[sel % len(vals)]
            y = vals[(sel // 7) % len(vals)]
            if x.dtype != y.dtype:
                y = y.astype(x.dtype)
            k = kind % _N_STEP_KINDS
            if k == 0:
                r = x + y
            elif k == 1:
                r = x - y
            elif k == 2:
                r = x * y
            elif k == 3:
                r = jnp.bitwise_xor(x, y)
            elif k == 4:
                r = jnp.minimum(x, y)
            elif k == 5:
                r = jnp.maximum(x, y)
            elif k == 6:
                r = jnp.where(x < y, x, y)
            else:
                r = x + jnp.sum(x)
            vals.append(r)
        return tuple(vals[-2:])
    return fn


def _torch_graph(steps):
    def fn(a, b):
        vals = [a, b]
        for kind, sel in steps:
            x = vals[sel % len(vals)]
            y = vals[(sel // 7) % len(vals)]
            if x.dtype != y.dtype:
                y = y.to(x.dtype)
            k = kind % _N_STEP_KINDS
            if k == 0:
                r = x + y
            elif k == 1:
                r = x - y
            elif k == 2:
                r = x * y
            elif k == 3:
                r = x ^ y
            elif k == 4:
                r = torch.minimum(x, y)
            elif k == 5:
                r = torch.maximum(x, y)
            elif k == 6:
                r = torch.where(x < y, x, y)
            else:
                acc = getattr(torch, _SUM_DTYPE.get(str(x.dtype)[6:],
                                                    str(x.dtype)[6:]))
                xs = x if x.dtype == acc else x.to(acc)
                r = (x if x.dtype == acc else x.to(acc)) \
                    + torch.sum(xs, dtype=acc)
            vals.append(r)
        return tuple(vals[-2:])
    return fn


def _operand(dtype, n_words, seed):
    info = np.iinfo(dtype)
    rng = np.random.RandomState(seed)
    return rng.randint(int(info.min), int(info.max) + 1, n_words,
                       dtype=np.int64).astype(dtype)


@pytest.mark.parametrize("seed", range(12))
def test_projected_counts_equal_executed_banked_ledger(seed):
    """For a random graph on a banked spec, the projected access count (sum
    of per-op banked accesses) equals the executed ledger exactly, the
    projected critical path (sum of per-op waves) equals the busiest bank
    slot's activations, and the result equals jnp's."""
    rng = np.random.RandomState(seed)
    dtype = DTYPES[seed % len(DTYPES)]
    steps = _steps(seed, int(rng.randint(1, 6)))
    a, b = _operand(dtype, 96, seed), _operand(dtype, 96, seed + 1)
    spec = TSpec(**SMALL)
    tfn = _torch_graph(steps)
    plan = tcost.plan_offload(ttrace(tfn, _torch(a), _torch(b)), spec=spec,
                              policy="always")
    est_accesses = sum(v.banked_accesses for v in plan.verdicts)
    est_waves = sum(v.waves for v in plan.verdicts)
    lf = lower(tfn, spec=spec, policy="always")
    TLEDGER.reset()
    got = lf(_torch(a), _torch(b))
    _assert_equal(got, jax.jit(_jnp_graph(steps))(a, b))
    assert TLEDGER.accesses == est_accesses
    assert max(TLEDGER.bank_accesses.values(), default=0) == est_waves


def test_schedule_placed_waves_is_the_cost_models_critical_path():
    spec = TSpec(**SMALL)
    sched = tplan.plan_multiply(8, 8)
    n_words = 96
    assert sched.placed_waves == len(sched.steps)
    placed = sched.placed(spec, n_words)
    assert placed.placed_waves == \
        len(sched.steps) * spec.plan(n_words).waves
    a = _torch(_operand(np.int8, n_words, 3))
    b = _torch(_operand(np.int8, n_words, 4))
    plan = tcost.plan_offload(ttrace(lambda x, y: x * y, a, b), spec=spec,
                              policy="always")
    v = max(plan.verdicts, key=lambda x: x.accesses)
    assert v.waves == placed.placed_waves


# ---------------------------------------------------------------------------
# policy semantics through the lowering compiler
# ---------------------------------------------------------------------------


def _sliver():
    a = torch.tensor([3, -9, 5, 7], dtype=torch.int16)
    return a, 5 - a


def test_default_policy_demotes_pad_dominated_shape():
    """4 useful words on 32-word tiles (12% utilization): the default edp
    policy keeps the op on the host, still bit-exact; "always" lowers it."""
    def fn(a, b):
        return a + b

    a, b = _sliver()
    spec = TSpec(**SLIVER)
    lf = lower(fn, spec=spec)
    comp = lf.trace(a, b)
    assert comp.policy == "edp"
    assert comp.accesses == 0 and len(comp.regions) == 0
    assert comp.offload_plan.demoted_eqns == 1
    v = comp.offload_plan.verdict_for(0)
    assert v is not None and not v.lowers and v.margin < 0
    assert "loses" in v.reason
    assert "demoted" in comp.describe()
    TLEDGER.reset()
    assert torch.equal(lf(a, b), fn(a, b))
    assert TLEDGER.accesses == 0

    forced = lower(fn, spec=spec, policy="always")
    comp_f = forced.trace(a, b)
    assert comp_f.accesses == 1 and len(comp_f.regions) == 1
    assert torch.equal(forced(a, b), fn(a, b))


def test_always_policy_bit_exact_with_default_on_winning_shapes():
    """On fully-utilized tiles the edp default demotes nothing: default and
    "always" give identical results AND identical dispatch counts."""
    def fn(a, b):
        t = (a + b) * b
        return torch.where(t < a, t, a), \
            torch.sum(t.to(torch.int32), dtype=torch.int32)

    a = torch.arange(-64, 64, dtype=torch.int16)
    b = 5 - a
    spec = TSpec(**SMALL)
    counts = {}
    for policy in (None, "always"):
        lf = lower(fn, spec=spec, policy=policy)
        comp = lf.trace(a, b)
        before = tdisp.cache_stats()["dispatches"]
        out = lf(a, b)
        counts[policy] = (comp.accesses,
                          tdisp.cache_stats()["dispatches"] - before)
        for g, w in zip(out, fn(a, b)):
            assert torch.equal(g, w)
    assert counts[None] == counts["always"]
    assert counts[None][0] > 0


def test_never_policy_hosts_everything():
    def fn(a, b):
        return (a + b) ^ a, int_contract(a.reshape(4, 8).to(torch.int8),
                                         b.reshape(8, 4).to(torch.int8))

    a = torch.arange(-16, 16, dtype=torch.int16)
    lf = lower(fn, policy="never")
    comp = lf.trace(a, a)
    assert comp.accesses == 0 and len(comp.regions) == 0
    # every eligible op, free wiring included: add, xor, two reshapes, two
    # converts and the contraction
    assert comp.offload_plan.demoted_eqns == \
        len(comp.offload_plan.verdicts) == 7
    TLEDGER.reset()
    for g, w in zip(lf(a, a), fn(a, a)):
        assert torch.equal(g, w)
    assert TLEDGER.accesses == 0


@pytest.mark.parametrize("device", ["v5e", "h100"])
def test_latency_policy_demotes_host_winning_sliver(device):
    """Physical-units policy: 4 words cannot amortize the array's access
    latency against either host roofline, so "latency" hosts them."""
    def fn(a, b):
        return a + b

    a, b = _sliver()
    lf = lower(fn, policy="latency",
               device=V5E if device == "v5e" else None)
    comp = lf.trace(a, b)
    assert comp.accesses == 0
    v = comp.offload_plan.verdict_for(0)
    assert not v.lowers and v.host_time_s < v.cim_time_s
    assert torch.equal(lf(a, b), fn(a, b))


def test_interior_loser_kept_fused_when_toll_dominates():
    """win / lose / win where 2048 packed words32 cross the loser: hosting
    it would unpack+repack all of them, so the plan keeps it fused."""
    _, _, tfn, args, _ = _twin_cases()[3]
    a, s = (_torch(x) for x in args)
    spec = TSpec(**SLIVER)
    plan = tcost.plan_offload(ttrace(tfn, a, s), spec=spec, policy="edp")
    assert plan.demoted_eqns == 0 and plan.fused_losses == 1
    v1 = plan.verdict_for(1)
    assert v1.fused and not v1.lowers
    lf = lower(tfn, spec=spec)
    comp = lf.trace(a, s)
    assert len(comp.regions) == 1
    assert "kept fused" in comp.describe()
    for g, w in zip(lf(a, s), tfn(a, s)):
        assert torch.equal(g, w)


def test_interior_loser_splits_run_when_nothing_crosses():
    _, _, tfn, args, _ = _twin_cases()[4]
    a, s = (_torch(x) for x in args)
    spec = TSpec(**SLIVER)
    plan = tcost.plan_offload(ttrace(tfn, a, s), spec=spec, policy="edp")
    assert 1 in plan.demoted and plan.fused_losses == 0
    assert plan.verdict_for(0).lowers and plan.verdict_for(2).lowers
    lf = lower(tfn, spec=spec)
    comp = lf.trace(a, s)
    assert len(comp.regions) == 2
    for g, w in zip(lf(a, s), tfn(a, s)):
        assert torch.equal(g, w)


def test_cim_wins_rows_match_reference(ref_capture):
    """The three representative shapes: lower, lower, host, with the
    reference's EDP figures (the device row does not enter them) and, on
    the reference's device row, its host times too."""
    rrows = rcost.cim_wins_rows()
    trows = tcost.cim_wins_rows()
    v5e_rows = tcost.cim_wins_rows(device=V5E)
    assert [r["lowers"] for r in trows] == [True, True, False]
    assert trows[2]["edp_margin_pct"] < 0 < trows[0]["edp_margin_pct"]
    for r, t, tv in zip(rrows, trows, v5e_rows):
        assert t["shape"] == r["shape"]
        for k in ("cim_edp", "baseline_edp", "edp_margin_pct",
                  "cim_time_ns"):
            assert t[k] == pytest.approx(r[k], rel=1e-9), k
        assert tv["host_time_ns"] == pytest.approx(r["host_time_ns"],
                                                   rel=1e-9)
        assert t["host_time_ns"] <= r["host_time_ns"]
    assert tcost.cim_wins_table().splitlines()[2:] == \
        rcost.cim_wins_table().splitlines()[2:]


# ---------------------------------------------------------------------------
# the energy model: anchors and sweeps
# ---------------------------------------------------------------------------


def _same_scheme(r, t):
    for part in ("read", "cim", "baseline"):
        rp, tp = getattr(r, part), getattr(t, part)
        assert tp.energy == pytest.approx(rp.energy, rel=1e-12)
        assert tp.latency == pytest.approx(rp.latency, rel=1e-12)
        assert tp.breakdown.keys() == rp.breakdown.keys()
        for k in rp.breakdown:
            assert tp.breakdown[k] == pytest.approx(rp.breakdown[k],
                                                    rel=1e-12)


def test_current_sensing_anchor_1024():
    r = tenergy.current_sensing(1024)
    assert r.speedup == pytest.approx(1.94, abs=0.01)
    assert r.energy_decrease_pct == pytest.approx(41.18, abs=0.2)
    assert r.edp_decrease_pct == pytest.approx(69.04, abs=1.2)
    assert r.cim.energy / r.read.energy == pytest.approx(1.24, abs=0.01)
    assert r.read.breakdown["bitline"] / r.read.energy == \
        pytest.approx(0.91, abs=0.01)
    assert r.cim.breakdown["bitline"] / r.cim.energy == \
        pytest.approx(0.74, abs=0.01)


def test_scheme_anchors_1024():
    r1 = tenergy.voltage_scheme1(1024)
    assert -23.0 <= r1.energy_decrease_pct <= -20.0
    assert 1.57 <= r1.speedup <= 1.73
    assert 23.26 <= r1.edp_decrease_pct <= 28.81 + 0.3
    assert r1.cim.breakdown["bitline"] / r1.read.breakdown["bitline"] == \
        pytest.approx(3.0)
    r2 = tenergy.voltage_scheme2(1024)
    assert 1.945 <= r2.speedup <= 1.983
    assert 35.5 <= r2.energy_decrease_pct <= 45.8
    assert 66.83 <= r2.edp_decrease_pct <= 72.6


def test_frequency_crossover_7p53_mhz():
    f = tenergy.frequency_crossover_hz()
    assert f == pytest.approx(7.53e6, rel=0.01)
    assert f == pytest.approx(renergy.frequency_crossover_hz(), rel=1e-12)
    lo = tenergy.scheme_energies_vs_frequency(1e6)
    hi = tenergy.scheme_energies_vs_frequency(50e6)
    assert lo["scheme2"] < lo["scheme1"]
    assert hi["scheme1"] < hi["scheme2"]


def test_parallelism_crossover_42pct():
    p = tenergy.parallelism_crossover()
    assert p == pytest.approx(0.42, abs=0.02)
    assert p == pytest.approx(renergy.parallelism_crossover(), rel=1e-12)
    lo = tenergy.scheme_energies_vs_parallelism(0.2)
    hi = tenergy.scheme_energies_vs_parallelism(0.9)
    assert lo["scheme2"] < lo["scheme1"]
    assert hi["scheme1"] < hi["scheme2"]


@pytest.mark.parametrize("rows", [256, 1024, 2048])
def test_crossover_curves_match_reference(rows):
    for f in (1e5, 1e6, 7.53e6, 5e7):
        r = renergy.scheme_energies_vs_frequency(f, rows)
        t = tenergy.scheme_energies_vs_frequency(f, rows)
        for k in r:
            assert t[k] == pytest.approx(r[k], rel=1e-12)
    for p in (0.05, 0.42, 0.9, 1.0):
        r = renergy.scheme_energies_vs_parallelism(p, rows, 16)
        t = tenergy.scheme_energies_vs_parallelism(p, rows, 16)
        for k in r:
            assert t[k] == pytest.approx(r[k], rel=1e-12)
    assert tenergy.frequency_crossover_hz(rows) == pytest.approx(
        renergy.frequency_crossover_hz(rows), rel=1e-12)
    assert tenergy.parallelism_crossover(rows) == pytest.approx(
        renergy.parallelism_crossover(rows), rel=1e-12)


@pytest.mark.parametrize("scheme", ["current", "scheme1", "scheme2"])
def test_sweeps_match_reference_and_grow_with_array_size(scheme):
    assert tenergy.ARRAY_SIZES == renergy.ARRAY_SIZES
    rs, ts = renergy.sweep(scheme), tenergy.sweep(scheme)
    assert list(ts) == list(rs)
    for size in rs:
        _same_scheme(rs[size], ts[size])
    if scheme == "current":
        sizes = sorted(ts)
        for metric in ("energy_decrease_pct", "speedup", "edp_decrease_pct"):
            assert all(np.diff([getattr(ts[s], metric) for s in sizes]) > 0)
        assert all(ts[s].speedup < 2.0 for s in sizes)


def test_edp_summary_anchor_notes_and_units_match_reference():
    r, t = renergy.edp_summary(), tenergy.edp_summary()
    assert t.keys() == r.keys()
    for scheme, row in r.items():
        for k, v in row.items():
            assert t[scheme][k] == pytest.approx(v, rel=1e-12)
        assert 23.2 - 0.3 <= t[scheme]["edp_decrease_pct"] <= 72.6 + 0.3
    assert tenergy.PAPER_ANCHORS == renergy.PAPER_ANCHORS
    for scheme, metrics in renergy.PAPER_ANCHORS.items():
        for metric in metrics:
            for at_1024 in (False, True):
                assert tenergy.anchor_note(scheme, metric, at_1024, " %") \
                    == renergy.anchor_note(scheme, metric, at_1024, " %")
    assert tenergy.to_ns(1.5) == renergy.to_ns(1.5)
    assert tenergy.CIM_SWING == renergy.CIM_SWING < tenergy.V_DD
