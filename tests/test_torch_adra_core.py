"""Port vs reference: the paper's device and circuit model (`core/fefet.py`,
`core/array.py`, `core/sensing.py`, `core/compute_module.py`,
`core/adra.py`).

One twin for each case of `tests/test_adra_core.py` (levels, margins, the
symmetric scheme's collapse, the SA contract, the OAI21 truth table,
exhaustive 4-bit add/sub/compare, all 16 Boolean functions, the dual-output
module), each run on the port on the CPU and held against the reference's
function on the same numpy inputs, plus the FeFET equations across their
regimes. Currents, charges and voltages within rtol 1e-5 (XLA's and torch's
exp/log1p differ by ulps; every margin is above 1 uA or 50 mV); bits and
integers exact.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import adra as radra
from repro.core import array as rarray
from repro.core import fefet as rfefet
from repro.core import sensing as rsense
from repro_torch.core import adra as tadra
from repro_torch.core import array as tarray
from repro_torch.core import fefet as tfefet
from repro_torch.core import sensing as tsense

# the packages export the function `compute_module` under the module's name
rcm = importlib.import_module("repro.core.compute_module")
tcm = importlib.import_module("repro_torch.core.compute_module")
RTOL = dict(rtol=1e-5, atol=0)
TCFG = tarray.AdraArrayConfig()
RCFG = rarray.AdraArrayConfig()
MODES = ("boolean", "analog")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _grid4():
    v = np.arange(-8, 8, dtype=np.int32)
    a, b = np.meshgrid(v, v, indexing="ij")
    return a.ravel(), b.ravel()


# ---------------------------------------------------------------------------
# configs and the FeFET equations
# ---------------------------------------------------------------------------


def test_dataclass_defaults_match_reference():
    for t, r in ((tfefet.FEParams(), rfefet.FEParams()),
                 (tfefet.FeFETParams(), rfefet.FeFETParams()),
                 (tfefet.BiasConditions(), rfefet.BiasConditions())):
        for f in ("Ps", "Pr", "Ec", "alpha", "eps_r", "t_fe", "tau",
                  "vt_lrs", "vt_hrs", "k_beta", "n_ss", "lambda_ch",
                  "temp_vt", "v_read", "v_gread", "v_gread1", "v_gread2",
                  "v_set", "v_reset"):
            if hasattr(r, f):
                assert getattr(t, f) == getattr(r, f), f
    fe_t, fe_r = tfefet.FEParams(), rfefet.FEParams()
    assert fe_t.sigma == fe_r.sigma
    assert fe_t.coercive_voltage == fe_r.coercive_voltage
    assert fe_t.c_fe_linear == fe_r.c_fe_linear
    assert tfefet.FeFETParams().memory_window == \
        rfefet.FeFETParams().memory_window
    assert (TCFG.rows, TCFG.cols, TCFG.word_bits, TCFG.words_per_row) == \
        (RCFG.rows, RCFG.cols, RCFG.word_bits, RCFG.words_per_row)


@pytest.mark.parametrize("branch", [1, -1])
def test_ferroelectric_layer_matches_reference(branch):
    v = np.linspace(-3.0, 3.0, 97).astype(np.float32)
    for fn in ("polarization", "fe_charge", "fe_capacitance"):
        got = getattr(tfefet, fn)(torch.from_numpy(v), tfefet.FEParams(),
                                  branch)
        want = getattr(rfefet, fn)(jnp.asarray(v), rfefet.FEParams(), branch)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-6 * float(np.abs(want).max()))


def test_drain_current_matches_reference_in_every_regime():
    """Deep subthreshold to strong inversion, and past the softplus's
    overflow guard (x > 30 needs V_GS - V_T > 2.25 V)."""
    rng = np.random.RandomState(0)
    v_gs = np.concatenate([np.linspace(-1.0, 4.0, 201),
                           rng.uniform(-1, 4, 55)]).astype(np.float32)
    v_t = rng.choice([0.25, 1.45], v_gs.shape).astype(np.float32)
    v_ds = rng.uniform(0.0, 1.2, v_gs.shape).astype(np.float32)
    got = tfefet.drain_current(*(torch.from_numpy(x) for x in (v_gs, v_ds,
                                                                v_t)),
                               tfefet.FeFETParams())
    want = rfefet.drain_current(jnp.asarray(v_gs), jnp.asarray(v_ds),
                                jnp.asarray(v_t), rfefet.FeFETParams())
    assert bool(((v_gs - v_t) / (2 * 1.45 * 0.02585) > 30).any())
    np.testing.assert_allclose(_np(got), np.asarray(want), **RTOL)


@pytest.mark.parametrize("bias", [0.83, 1.0])
def test_read_currents_and_cell_current_match_reference(bias):
    got = tfefet.read_currents(tfefet.FeFETParams(), bias, device="cpu")
    want = rfefet.read_currents(rfefet.FeFETParams(), bias)
    np.testing.assert_allclose(_np(got), np.asarray(want), **RTOL)
    assert float(got[1]) > float(got[0])
    bits = np.array([0, 1, 1, 0, 1], np.int32)
    np.testing.assert_allclose(
        _np(tarray.single_cell_read_current(torch.from_numpy(bits), TCFG)),
        np.asarray(rarray.single_cell_read_current(jnp.asarray(bits), RCFG)),
        **RTOL)


def test_write_polarization_matches_reference():
    for v in (-6.0, -0.81, -0.79, 0.0, 0.79, 0.81, 3.7):
        assert tfefet.write_polarization(v, tfefet.FeFETParams()) == \
            rfefet.write_polarization(v, rfefet.FeFETParams())


# ---------------------------------------------------------------------------
# device / sensing layer (Fig 3b-c): the test_adra_core.py twins
# ---------------------------------------------------------------------------


def test_four_distinct_levels_strictly_ordered():
    for asym in (True, False):
        lv = _np(tarray.level_currents(TCFG, asymmetric=asym, device="cpu"))
        np.testing.assert_allclose(
            lv, np.asarray(rarray.level_currents(RCFG, asymmetric=asym)),
            **RTOL)
    lv = _np(tarray.level_currents(TCFG, device="cpu"))
    # one-to-one mapping: I(0,0) < I(1,0) < I(0,1) < I(1,1)
    assert np.all(np.diff(lv) > 0), lv


def test_current_sense_margin_exceeds_1uA():
    margins = _np(tsense.current_sense_margins(TCFG, device="cpu"))
    np.testing.assert_allclose(
        margins, np.asarray(rsense.current_sense_margins(RCFG)), **RTOL)
    assert np.all(margins > 1e-6), margins  # paper: > 1 uA


def test_voltage_sense_margin_exceeds_50mV():
    for t_sense in (1.0e-9, 0.5e-9):
        margins = _np(tsense.voltage_sense_margins(TCFG, t_sense,
                                                   device="cpu"))
        np.testing.assert_allclose(
            margins, np.asarray(rsense.voltage_sense_margins(RCFG, t_sense)),
            **RTOL)
    margins = _np(tsense.voltage_sense_margins(TCFG, device="cpu"))
    assert np.all(margins > 50e-3), margins  # paper: > 50 mV
    i = np.array([1e-6, 4e-5, 1e-4], np.float32)
    np.testing.assert_allclose(
        _np(tarray.rbl_discharge_voltage(torch.from_numpy(i), 1e-9, TCFG)),
        np.asarray(rarray.rbl_discharge_voltage(jnp.asarray(i), 1e-9, RCFG)),
        **RTOL)


def test_symmetric_assertion_is_many_to_one():
    # prior-work failure mode the paper fixes: (0,1) vs (1,0) ambiguous
    assert tsense.symmetric_sense_is_ambiguous(TCFG, device="cpu")
    assert rsense.symmetric_sense_is_ambiguous(RCFG)


def test_sense_amp_outputs_match_boolean_contract():
    refs = tsense.SenseReferences.from_config(TCFG)
    rrefs = rsense.SenseReferences.from_config(RCFG)
    for f in ("i_ref_or", "i_ref_b", "i_ref_and"):
        assert getattr(refs, f) == pytest.approx(getattr(rrefs, f), rel=1e-5)
    assert tsense.SenseReferences.from_config(tarray.AdraArrayConfig()) \
        is refs                                  # computed once per config
    a = np.array([0, 1, 0, 1])
    b = np.array([0, 0, 1, 1])
    out = tsense.sense(tarray.senseline_current(
        torch.from_numpy(a), torch.from_numpy(b), TCFG), refs)
    rout = rsense.sense(rarray.senseline_current(
        jnp.asarray(a), jnp.asarray(b), RCFG), rrefs)
    for g, r, want in zip(out, rout, (a | b, a & b, b, a)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(_np(g), want)
        np.testing.assert_array_equal(_np(g), np.asarray(r))


def test_senseline_current_broadcasts_like_reference():
    rng = np.random.RandomState(1)
    a, b = rng.randint(0, 2, (2, 7, 9))
    for asym in (True, False):
        np.testing.assert_allclose(
            _np(tarray.senseline_current(torch.from_numpy(a),
                                         torch.from_numpy(b), TCFG, asym)),
            np.asarray(rarray.senseline_current(jnp.asarray(a),
                                                jnp.asarray(b), RCFG, asym)),
            **RTOL)


def test_oai21_truth_table():
    for a in (0, 1):
        for b in (0, 1):
            got = tsense.oai21_recover_a(torch.tensor(a | b),
                                         torch.tensor(a & b), torch.tensor(b))
            assert int(got) == a == int(rsense.oai21_recover_a(
                jnp.array(a | b), jnp.array(a & b), jnp.array(b))), (a, b)


def test_analog_equals_boolean_mode():
    rng = np.random.RandomState(0)
    x = rng.randint(-128, 128, 64).astype(np.int32)
    y = rng.randint(-128, 128, 64).astype(np.int32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got = _np(tadra.cim_sub(tx, ty, 8, "analog").value)
    np.testing.assert_array_equal(got, _np(tadra.cim_sub(tx, ty, 8,
                                                         "boolean").value))
    np.testing.assert_array_equal(
        got, np.asarray(radra.cim_sub(jnp.asarray(x), jnp.asarray(y), 8,
                                      "analog").value))
    with pytest.raises(ValueError):
        tadra.cim_sub(tx, ty, 8, "digital")


# ---------------------------------------------------------------------------
# arithmetic (Sec. III-B): subtraction, comparison, overflow module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_subtraction_exhaustive_4bit(mode):
    a, b = _grid4()
    got = tadra.cim_sub(torch.from_numpy(a), torch.from_numpy(b), 4, mode)
    want = radra.cim_sub(jnp.asarray(a), jnp.asarray(b), 4, mode)
    np.testing.assert_array_equal(_np(got.value), a - b)  # never overflows
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("mode", MODES)
def test_addition_exhaustive_4bit(mode):
    a, b = _grid4()
    got = tadra.cim_add(torch.from_numpy(a), torch.from_numpy(b), 4, mode)
    want = radra.cim_add(jnp.asarray(a), jnp.asarray(b), 4, mode)
    np.testing.assert_array_equal(_np(got.value), a + b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("mode", MODES)
def test_comparison_exhaustive_4bit(mode):
    a, b = _grid4()
    c = tadra.cim_compare(torch.from_numpy(a), torch.from_numpy(b), 4, mode)
    rc = radra.cim_compare(jnp.asarray(a), jnp.asarray(b), 4, mode)
    np.testing.assert_array_equal(_np(c.lt), (a < b).astype(np.int32))
    np.testing.assert_array_equal(_np(c.eq), (a == b).astype(np.int32))
    np.testing.assert_array_equal(_np(c.gt), (a > b).astype(np.int32))
    for g, w in zip(c, rc):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@settings(max_examples=50, deadline=None)
@given(st.lists(st.integers(-2**15, 2**15 - 1), min_size=1, max_size=32),
       st.lists(st.integers(-2**15, 2**15 - 1), min_size=1, max_size=32))
def test_sub_compare_property_16bit(xs, ys):
    n = min(len(xs), len(ys))
    a = np.array(xs[:n], np.int32)
    b = np.array(ys[:n], np.int32)
    for mode in MODES:
        out = tadra.cim_sub(torch.from_numpy(a), torch.from_numpy(b), 16,
                            mode)
        np.testing.assert_array_equal(_np(out.value), a - b)
        c = tadra.cim_compare(torch.from_numpy(a), torch.from_numpy(b), 16,
                              mode)
        np.testing.assert_array_equal(_np(c.lt), (a < b).astype(np.int32))
    np.testing.assert_array_equal(
        _np(out.sum_bits), np.asarray(radra.cim_sub(
            jnp.asarray(a), jnp.asarray(b), 16).sum_bits))


@pytest.mark.parametrize("fn", tadra.BOOLEAN_FUNCTIONS)
def test_all_16_boolean_functions(fn):
    assert tadra.BOOLEAN_FUNCTIONS == radra.BOOLEAN_FUNCTIONS
    v = np.arange(16, dtype=np.int32)
    a, b = (x.ravel() for x in np.meshgrid(v, v, indexing="ij"))
    m = 15
    ref = {
        "false": np.zeros_like(a), "true": np.full_like(a, m),
        "and": a & b, "or": a | b, "xor": a ^ b,
        "nand": (~(a & b)) & m, "nor": (~(a | b)) & m, "xnor": (~(a ^ b)) & m,
        "a": a, "b": b, "not_a": (~a) & m, "not_b": (~b) & m,
        "a_and_not_b": a & ((~b) & m), "not_a_and_b": ((~a) & m) & b,
        "a_or_not_b": a | ((~b) & m), "not_a_or_b": ((~a) & m) | b,
    }[fn]
    want = np.asarray(radra.cim_boolean(jnp.asarray(a), jnp.asarray(b), fn,
                                        n_bits=4))
    for mode in MODES:
        got = tadra.cim_boolean(torch.from_numpy(a), torch.from_numpy(b), fn,
                                4, mode)
        np.testing.assert_array_equal(_np(got), ref)
        np.testing.assert_array_equal(_np(got), want)


def test_single_access_yields_all_three_sa_outputs():
    """The one-access contract: OR, AND, B (and A) from a single activation."""
    a = np.array([[0, 1, 0, 1]])
    b = np.array([[0, 0, 1, 1]])
    acc = tadra.adra_access(torch.from_numpy(a), torch.from_numpy(b),
                            mode="analog")
    racc = radra.adra_access(jnp.asarray(a), jnp.asarray(b), mode="analog")
    for got, want, r in zip(acc, ([0, 1, 1, 1], [0, 0, 0, 1], [0, 0, 1, 1],
                                  [0, 1, 0, 1]), racc):
        np.testing.assert_array_equal(_np(got[0]), want)
        np.testing.assert_array_equal(_np(got), np.asarray(r))
    for g, w in zip(tadra.adra_access(torch.from_numpy(a),
                                      torch.from_numpy(b)), acc):
        assert torch.equal(g, w)                  # boolean mode agrees
    with pytest.raises(ValueError):
        tadra.adra_access(torch.from_numpy(a), torch.from_numpy(b),
                          mode="ideal")


@pytest.mark.parametrize("mode", MODES)
def test_dual_output_module_add_and_sub_same_cycle(mode):
    """Paper Sec. III-B alternate design: both outputs from one access."""
    a, b = _grid4()
    out = tadra.cim_add_sub(torch.from_numpy(a), torch.from_numpy(b), 4, mode)
    rout = radra.cim_add_sub(jnp.asarray(a), jnp.asarray(b), 4, mode)
    np.testing.assert_array_equal(_np(out.add), a + b)
    np.testing.assert_array_equal(_np(out.sub), a - b)
    np.testing.assert_array_equal(_np(out.add), np.asarray(rout.add))
    np.testing.assert_array_equal(_np(out.sub), np.asarray(rout.sub))


def test_dual_module_transistor_overhead_documented():
    # paper: the dual-output design costs 4 extra transistors vs the muxes
    assert tcm.EXTRA_TRANSISTORS_DUAL_OUTPUT_DESIGN - \
        tcm.EXTRA_TRANSISTORS_MUX_DESIGN == 4
    assert tcm.EXTRA_GATES_MUX_DESIGN == rcm.EXTRA_GATES_MUX_DESIGN
    assert tcm.EXTRA_TRANSISTORS_MUX_DESIGN == rcm.EXTRA_TRANSISTORS_MUX_DESIGN


# ---------------------------------------------------------------------------
# the compute module on random SA outputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_bits", [1, 3, 8, 17])
def test_ripple_chains_match_reference(n_bits):
    """Any SA-output triple (not only consistent ones), words on two
    leading axes: both mux selects and the dual module, sums and carries."""
    rng = np.random.RandomState(n_bits)
    o, n, b = rng.randint(0, 2, (3, 5, 6, n_bits)).astype(np.int32)
    t = [torch.from_numpy(x) for x in (o, n, b)]
    r = [jnp.asarray(x) for x in (o, n, b)]
    for select in (0, 1):
        got = tcm.ripple_chain(*t, select=select)
        want = rcm.ripple_chain(*r, select=select)
        assert got[0].shape == (5, 6, n_bits + 1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    for g, w in zip(tcm.ripple_chain_dual(*t), rcm.ripple_chain_dual(*r)):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    sums = rng.randint(0, 2, (9, n_bits + 1)).astype(np.int32)
    for g, w in zip(tcm.compare_from_sub(torch.from_numpy(sums)),
                    rcm.compare_from_sub(jnp.asarray(sums))):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    for g, w in zip(tcm.compute_module(*t, torch.from_numpy(o), 1),
                    rcm.compute_module(*r, jnp.asarray(o), 1)):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
