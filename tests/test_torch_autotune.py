"""Port vs reference: the geometry autotuner (`cim/autotune.py`).

The reference's six autotune cases (`tests/test_cim_cost.py`) run against
the port on its CPU backend, and the port's projections are held to the
reference's `Autotuner` on the same function: the predicted EDP of every
candidate of `DEFAULT_CANDIDATES` equal (1e-9 relative) and the same
predict-only winner (`jnp-boolean` against `torch-boolean`, both on the
reference's device row). The reference's capture needs the
`jax.core.Literal`/`Var` aliases under JAX 0.9, applied per test.
"""
import jax
import jax.extend.core as jex
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cim import autotune as rtune
from repro.cim import cost as rcost
from repro.cim import dispatch as rdisp
from repro_torch.cim import autotune as ttune
from repro_torch.cim import cost as tcost
from repro_torch.cim import dispatch as tdisp
from repro_torch.cim.accounting import LEDGER as TLEDGER
from repro_torch.cim.autotune import (DEFAULT_CANDIDATE, Autotuner, Candidate,
                                      steady_ms)
from repro_torch.cim.cost import DeviceSpec

BACKEND = "torch-boolean"


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


def _fn(a, b):
    return (a + b) * b


def _tune_fn():
    a = torch.arange(-32, 32, dtype=torch.int16)
    return _fn, (a, 5 - a)


_SMALL_CANDIDATES = (
    Candidate(banks=2, subarrays=2, bitline_words=1024),
    Candidate(banks=4, subarrays=4, bitline_words=1024, scheme="scheme2"),
)


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_cim_cost.py), against the port
# ---------------------------------------------------------------------------


def test_autotune_predict_only_deterministic():
    fn, args = _tune_fn()
    tuner = Autotuner()
    r1 = tuner.tune(fn, args, candidates=_SMALL_CANDIDATES,
                    backend=BACKEND, measure=False)
    assert tuner.searches == 1 and not r1.from_cache
    assert repr(DEFAULT_CANDIDATE) in r1.predicted_edp
    assert r1.predicted_edp[repr(r1.winner)] <= \
        r1.predicted_edp[repr(DEFAULT_CANDIDATE)]
    assert r1.tuned_vs_default_edp_ratio >= 1.0

    r2 = Autotuner().tune(fn, args, candidates=_SMALL_CANDIDATES,
                          backend=BACKEND, measure=False)
    assert r2.winner == r1.winner and r2.predicted_edp == r1.predicted_edp


def test_autotune_measured_never_regresses_default():
    fn, args = _tune_fn()
    tuner = Autotuner()
    res = tuner.tune(fn, args, candidates=_SMALL_CANDIDATES,
                     backend=BACKEND, steady_n=1)
    assert res.default_ms is not None and res.tuned_ms is not None
    assert res.tuned_ms <= res.default_ms
    assert res.tuned_vs_default_walltime_ratio >= 1.0
    assert res.tuned_vs_default_edp_ratio >= 1.0
    assert res.measured_ms                    # at least the default measured


def test_autotune_warm_cache_skips_search():
    fn, args = _tune_fn()
    tuner = Autotuner()
    cold = tuner.tune(fn, args, candidates=_SMALL_CANDIDATES,
                      backend=BACKEND, measure=False)
    assert tuner.searches == 1
    warm = tuner.tune(fn, args, candidates=_SMALL_CANDIDATES,
                      backend=BACKEND, measure=False)
    assert warm.from_cache and warm.winner == cold.winner
    assert warm.key == cold.key
    assert tuner.searches == 1                # zero re-searches
    assert tuner.winners.stats()["hits"] == 1


def test_autotune_winners_json_roundtrip(tmp_path):
    fn, args = _tune_fn()
    tuner = Autotuner()
    cold = tuner.tune(fn, args, candidates=_SMALL_CANDIDATES,
                      backend=BACKEND, measure=False)
    path = str(tmp_path / "winners.json")
    tuner.save(path)

    fresh = Autotuner()
    assert fresh.load(path) == 1
    warm = fresh.tune(fn, args, candidates=_SMALL_CANDIDATES,
                      backend=BACKEND, measure=False)
    assert warm.from_cache and warm.winner == cold.winner
    assert fresh.searches == 0                # the whole point of the file

    other = Autotuner(device=DeviceSpec(name="not-this-chip"))
    with pytest.raises(ValueError):
        other.load(path)


def test_autotune_winners_table_is_bounded():
    tuner = Autotuner(capacity=1)
    fn1, args1 = _tune_fn()

    def fn2(a, b):
        return a - b

    tuner.tune(fn1, args1, candidates=(), backend=BACKEND, measure=False)
    tuner.tune(fn2, args1, candidates=(), backend=BACKEND, measure=False)
    assert len(tuner.winners) == 1            # first winner evicted
    assert tuner.winners.stats()["evictions"] == 1


def test_steady_ms_counts_only_steady_calls():
    calls = []
    ms = steady_ms(lambda: calls.append(1), n=3)
    assert len(calls) == 4                    # 1 warmup + 3 timed
    assert ms >= 0.0


# ---------------------------------------------------------------------------
# the port's projections against the reference's tuner
# ---------------------------------------------------------------------------


def _both_tuners():
    row = rcost.DEFAULT_DEVICE.to_dict()
    return (rtune.Autotuner(device=rcost.DeviceSpec.from_dict(row)),
            Autotuner(device=tcost.DeviceSpec.from_dict(row)))


@pytest.mark.parametrize("kind", ["add_mul", "matmul"])
def test_predicted_edp_and_winner_match_reference(ref_capture, kind):
    rng = np.random.RandomState(3)
    if kind == "add_mul":
        x = rng.randint(-32, 32, 96).astype(np.int16)
        y = rng.randint(-32, 32, 96).astype(np.int16)

        def rfn(a, b):
            return (a + b) * b
        tfn = rfn
    else:
        from repro_torch.cim.trace import int_contract

        x = rng.randint(-8, 8, (4, 24)).astype(np.int8)
        y = rng.randint(-8, 8, (24, 16)).astype(np.int8)

        def rfn(a, b):
            return jnp.matmul(a, b, preferred_element_type=jnp.int32)

        def tfn(a, b):
            return int_contract(a, b)
    rt, tt = _both_tuners()
    r = rt.tune(rfn, (jnp.asarray(x), jnp.asarray(y)),
                candidates=rtune.DEFAULT_CANDIDATES, backend="jnp-boolean",
                measure=False)
    t = tt.tune(tfn, (torch.from_numpy(x), torch.from_numpy(y)),
                candidates=ttune.DEFAULT_CANDIDATES, backend=BACKEND,
                measure=False)
    assert set(t.predicted_edp) == set(r.predicted_edp)
    assert len(t.predicted_edp) == len(ttune.DEFAULT_CANDIDATES)
    for name, edp in r.predicted_edp.items():
        assert t.predicted_edp[name] == pytest.approx(edp, rel=1e-9), name
    assert repr(t.winner) == repr(r.winner)
    assert t.tuned_vs_default_edp_ratio == pytest.approx(
        r.tuned_vs_default_edp_ratio, rel=1e-9)
