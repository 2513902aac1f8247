"""The port's fault layer against the reference's, bit for bit.

Every case of tests/test_cim_faults.py, run through both packages on the
same numpy-seeded inputs: the SECDED codec (parity planes and repaired
planes equal to the bit, counts equal), the seeded injection (the same
flipped bit positions for the same seed, since both draw from numpy's
PCG64 in the same order), ECC-protected pins (verify on get, invalidate
or raise, scrub with retention decay), the ledger's `ecc_*`/`fault_*`
fields, degraded specs and `PagedKV.migrate`, the host-failure hook under
the port's Supervisor, and the cost model's ECC overhead. The tolerance is
0 throughout. Lowered calls and schedule programs never inject, as the
reference's jitted ones cannot.
"""
import jax
import jax.extend.core as jex
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cim import array as rarray
from repro.cim import dispatch as rdispatch
from repro.cim import engine as rengine
from repro.cim import faults as rfaults
from repro.cim import planepack as rpp
from repro.cim.accounting import LEDGER as RLEDGER
from repro_torch.cim import array as tarray
from repro_torch.cim import dispatch as tdispatch
from repro_torch.cim import engine as tengine
from repro_torch.cim import faults as tfaults
from repro_torch.cim import planepack as tpp
from repro_torch.cim.accounting import LEDGER as TLEDGER
from repro_torch.cim.opset import CimOpError

#: the reference's test geometries (tests/test_cim_faults.py)
SPEC_KW = dict(banks=2, subarrays=1, rows=64, bitline_words=32)
ECC_SPEC_KW = dict(banks=4, subarrays=1, rows=256, bitline_words=32)

LEDGER_FIELDS = ("accesses", "load_accesses", "load_words32",
                 "ecc_accesses", "ecc_words32", "fault_injected",
                 "fault_detected", "fault_corrected", "fault_uncorrected")


@pytest.fixture(autouse=True)
def _clean_overlay():
    def clean():
        for m in (rfaults, tfaults):
            m.uninstall()
            m.reset_fault_stats()
        rarray.set_resident_ecc(False)
        tarray.set_resident_ecc(False)
        rarray.clear_resident()
        tarray.clear_resident()
        RLEDGER.reset()
        TLEDGER.reset()
    clean()
    yield
    clean()


def _u32(t) -> np.ndarray:
    """uint32 patterns of a port (int32) or reference (uint32) plane stack."""
    if isinstance(t, torch.Tensor):
        return t.numpy().view(np.uint32)
    return np.asarray(t, dtype=np.uint32)


def _t(planes_u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(planes_u32).view(np.int32))


def _packs(n=128, bits=8):
    """The reference test's operands, packed by both packages."""
    x = np.arange(n, dtype=np.int32) % 100
    y = np.ones(n, dtype=np.int32)
    rp = (rpp.PlanePack.pack(jnp.asarray(x), bits),
          rpp.PlanePack.pack(jnp.asarray(y), bits))
    tp = (tpp.PlanePack.pack(torch.from_numpy(x), bits),
          tpp.PlanePack.pack(torch.from_numpy(y), bits))
    return x, y, rp, tp


def _ledgers_equal():
    for f in LEDGER_FIELDS:
        assert getattr(TLEDGER, f) == getattr(RLEDGER, f), f


# ---------------------------------------------------------------------------
# SECDED codec
# ---------------------------------------------------------------------------


def _check_both(planes: np.ndarray, parity: np.ndarray):
    """ecc_check_correct through both packages: repaired planes, repaired
    parity and both counts equal; returns the reference's result."""
    rd, rpar, rc, ru = rpp.ecc_check_correct(planes, parity)
    td, tpar, tc, tu = tpp.ecc_check_correct(_t(planes), _t(parity))
    assert (tc, tu) == (rc, ru)
    np.testing.assert_array_equal(_u32(td), rd)
    np.testing.assert_array_equal(_u32(tpar), rpar)
    return rd, rpar, rc, ru


@pytest.mark.parametrize("n_bits", list(range(1, 34)))
def test_plane_counts(n_bits):
    assert tpp.ecc_plane_count(n_bits) == rpp.ecc_plane_count(n_bits)
    assert tpp._hamming_data_positions(n_bits) == \
        rpp._hamming_data_positions(n_bits)


def test_plane_counts_classic_values():
    assert [tpp.ecc_plane_count(m) for m in (1, 4, 8, 16)] == [3, 4, 5, 6]
    with pytest.raises(ValueError):
        tpp.ecc_plane_count(0)


@pytest.mark.parametrize("m,w", [(8, 6), (1, 3), (4, 5), (16, 2), (29, 7)])
def test_clean_roundtrip(m, w):
    pl = np.random.default_rng(m * 10 + w).integers(
        0, 2**32, size=(m, w), dtype=np.uint32)
    par = rpp.ecc_encode(pl)
    np.testing.assert_array_equal(_u32(tpp.ecc_encode(_t(pl))), par)
    data, p2, c, u = _check_both(pl, par)
    assert c == 0 and u == 0 and (data == pl).all() and (p2 == par).all()


@pytest.mark.parametrize("plane", range(8))
def test_corrects_every_single_data_bit(plane):
    pl = np.random.default_rng(1).integers(0, 2**32, size=(8, 2),
                                           dtype=np.uint32)
    par = rpp.ecc_encode(pl)
    for bit in (0, 13, 31, 45):
        bad = pl.copy()
        bad[plane, bit // 32] ^= np.uint32(1) << np.uint32(bit % 32)
        data, _, c, u = _check_both(bad, par)
        assert c == 1 and u == 0 and (data == pl).all()


@pytest.mark.parametrize("pplane", range(5))
def test_corrects_single_parity_bit(pplane):
    pl = np.random.default_rng(2).integers(0, 2**32, size=(8, 2),
                                           dtype=np.uint32)
    par = rpp.ecc_encode(pl)
    bad = par.copy()
    bad[pplane, 0] ^= np.uint32(1)
    data, fixed_par, c, u = _check_both(pl, bad)
    assert c == 1 and u == 0
    assert (data == pl).all() and (fixed_par == par).all()


@pytest.mark.parametrize("p1,p2", [(0, 1), (2, 7), (0, 7), (3, 4)])
def test_detects_double_never_miscorrects(p1, p2):
    pl = np.random.default_rng(3).integers(0, 2**32, size=(8, 2),
                                           dtype=np.uint32)
    par = rpp.ecc_encode(pl)
    bad = pl.copy()
    bad[p1, 0] ^= np.uint32(1)
    bad[p2, 0] ^= np.uint32(1)
    _, _, c, u = _check_both(bad, par)
    assert u == 1 and c == 0


def test_independent_columns():
    pl = np.random.default_rng(4).integers(0, 2**32, size=(8, 2),
                                           dtype=np.uint32)
    par = rpp.ecc_encode(pl)
    bad = pl.copy()
    bad[1, 0] ^= np.uint32(1 << 5)
    bad[6, 1] ^= np.uint32(1 << 20)
    data, _, c, u = _check_both(bad, par)
    assert c == 2 and u == 0 and (data == pl).all()


@pytest.mark.parametrize("seed", range(6))
def test_dense_random_damage_matches_reference(seed):
    """Many flips at once, singles, doubles and 3+ in one column alike
    (including miscorrections past the SECDED bound): planes, parity and
    counts equal to the reference's, bit for bit."""
    rng = np.random.default_rng(100 + seed)
    m = int(rng.integers(1, 20))
    pl = rng.integers(0, 2**32, size=(m, 9), dtype=np.uint32)
    par = rpp.ecc_encode(pl)
    np.testing.assert_array_equal(_u32(tpp.ecc_encode(_t(pl))), par)
    bad, bad_par = pl.copy(), par.copy()
    flips = rng.random(bad.shape) < 0.3
    bad ^= np.where(flips, rng.integers(0, 2**32, size=bad.shape,
                                        dtype=np.uint32), 0).astype(np.uint32)
    bad_par ^= (rng.integers(0, 2**32, size=par.shape, dtype=np.uint32)
                & rng.integers(0, 2**32, size=par.shape, dtype=np.uint32)
                & rng.integers(0, 2**32, size=par.shape, dtype=np.uint32))
    _, _, c, u = _check_both(bad, bad_par)
    assert c + u > 0


def test_popcount_total_counts_bit_31():
    x = torch.tensor([-1, 1 << 30, -(1 << 31), 0], dtype=torch.int32)
    assert int(tpp.popcount_total(x)) == 32 + 1 + 1


# ---------------------------------------------------------------------------
# deterministic injection: the reference's very bits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,ber,shape", [
    (0, 1e-2, (8, 4)), (1, 2e-3, (16, 40)), (7, 0.5, (2, 1)),
    (3, 0.3, (3, 2)), (11, 1e-4, (29, 1000))])
def test_flipped_bits_equal_the_reference(seed, ber, shape):
    """corrupt_streamed and corrupt_resident on the same planes and seed
    flip the same bits (a position drawn twice flips twice), count the
    same n and leave the generators in the same state."""
    pl = np.random.default_rng(seed).integers(0, 2**32, size=shape,
                                              dtype=np.uint32)
    rfm = rfaults.FaultModel(rfaults.FaultConfig(seed=seed, ber=ber,
                                                 resident_ber=ber))
    tfm = tfaults.FaultModel(tfaults.FaultConfig(seed=seed, ber=ber,
                                                 resident_ber=ber))
    for _ in range(3):
        ra, rn = rfm.corrupt_streamed(pl)
        ta, tn = tfm.corrupt_streamed(_t(pl))
        assert tn == rn
        np.testing.assert_array_equal(_u32(ta), ra)
        ra, rn = rfm.corrupt_resident(pl)
        ta, tn = tfm.corrupt_resident(_t(pl))
        assert tn == rn
        np.testing.assert_array_equal(_u32(ta), ra)
    assert tfm.injected == rfm.injected
    assert tfm.rng.integers(0, 2**62) == rfm.rng.integers(0, 2**62)


def test_same_seed_same_faults():
    _, _, (rpa, rpb), (tpa, tpb) = _packs()
    spec_r, spec_t = rarray.ArraySpec(**SPEC_KW), tarray.ArraySpec(**SPEC_KW)
    with rfaults.faults(rfaults.FaultConfig(seed=1, ber=2e-3)) as rfm:
        rd = np.asarray(rdispatch.execute_tiled(
            rpa, rpb, ("add",), spec=spec_r)["add"].unpack())
    outs = []
    for _ in range(2):
        with tfaults.faults(tfaults.FaultConfig(seed=1, ber=2e-3)) as tfm:
            outs.append(tdispatch.execute_tiled(
                tpa, tpb, ("add",), spec=spec_t)["add"].unpack().numpy())
        assert tfm.injected == rfm.injected > 0
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], rd)


def test_different_seed_different_faults():
    _, _, (rpa, rpb), (tpa, tpb) = _packs()
    spec_r, spec_t = rarray.ArraySpec(**SPEC_KW), tarray.ArraySpec(**SPEC_KW)
    outs = []
    for seed in (1, 2):
        with rfaults.faults(rfaults.FaultConfig(seed=seed, ber=2e-3)):
            r = np.asarray(rdispatch.execute_tiled(
                rpa, rpb, ("add",), spec=spec_r)["add"].unpack())
        with tfaults.faults(tfaults.FaultConfig(seed=seed, ber=2e-3)):
            t = tdispatch.execute_tiled(tpa, tpb, ("add",),
                                        spec=spec_t)["add"].unpack().numpy()
        np.testing.assert_array_equal(t, r)
        outs.append(t)
    assert not (outs[0] == outs[1]).all()


def test_no_model_no_change():
    x, y, _, (tpa, tpb) = _packs()
    out = tdispatch.execute_tiled(tpa, tpb, ("add",),
                                  spec=tarray.ArraySpec(**SPEC_KW))
    np.testing.assert_array_equal(out["add"].unpack().numpy(), x + y)
    assert tfaults.fault_stats()["fault_injected"] == 0


def test_engine_path_injects():
    _, _, (rpa, rpb), (tpa, tpb) = _packs()
    with rfaults.faults(rfaults.FaultConfig(seed=2, ber=5e-3)) as rfm:
        r = np.asarray(rengine.execute(rpa, rpb, ("add",))["add"].unpack())
    with tfaults.faults(tfaults.FaultConfig(seed=2, ber=5e-3)) as tfm:
        t = tengine.execute(tpa, tpb, ("add",))["add"].unpack().numpy()
    assert tfm.injected == rfm.injected > 0
    assert tdispatch.cache_stats()["fault_injected"] == tfm.injected
    np.testing.assert_array_equal(t, r)
    _ledgers_equal()


@pytest.mark.parametrize("stuck", [((1, 0, 1),), ((0, 3, 0), (1, 7, 1)),
                                   ((1, 0, 1), (1, 0, 0)), ((0, 20, 1),)])
def test_stuck_rows_hit_only_their_bank(stuck):
    x, y, (rpa, rpb), (tpa, tpb) = _packs()
    spec_t = tarray.ArraySpec(**SPEC_KW)
    clean = tdispatch.execute_tiled(tpa, tpb, ("add",),
                                    spec=spec_t)["add"].unpack().numpy()
    with rfaults.faults(rfaults.FaultConfig(seed=0, stuck=stuck)) as rfm:
        r = np.asarray(rdispatch.execute_tiled(
            rpa, rpb, ("add",), spec=rarray.ArraySpec(**SPEC_KW))
            ["add"].unpack())
    with tfaults.faults(tfaults.FaultConfig(seed=0, stuck=stuck)) as tfm:
        t = tdispatch.execute_tiled(tpa, tpb, ("add",),
                                    spec=spec_t)["add"].unpack().numpy()
    np.testing.assert_array_equal(t, r)
    assert tfm.injected == rfm.injected
    if stuck == ((1, 0, 1),):
        # bank 1 owns tiles 1 and 3 of the 4-tile placement: words 32..63
        # and 96..127; bank 0's words are untouched
        diff = t != clean
        assert not diff[:32].any() and not diff[64:96].any()
        assert diff[32:64].any() or diff[96:128].any()


def test_stuck_rows_follow_a_degraded_placement():
    """Bank 1 dead: every tile lands on bank 0, so a stuck row of bank 0
    hits every word, one of bank 1 none."""
    _, _, (rpa, rpb), (tpa, tpb) = _packs()
    for stuck in (((0, 0, 1),), ((1, 0, 1),)):
        with rfaults.faults(rfaults.FaultConfig(stuck=stuck)) as rfm:
            r = np.asarray(rdispatch.execute_tiled(
                rpa, rpb, ("add",),
                spec=rarray.ArraySpec(**SPEC_KW).disable_bank(1))
                ["add"].unpack())
        with tfaults.faults(tfaults.FaultConfig(stuck=stuck)) as tfm:
            t = tdispatch.execute_tiled(
                tpa, tpb, ("add",),
                spec=tarray.ArraySpec(**SPEC_KW).disable_bank(1))[
                "add"].unpack().numpy()
        np.testing.assert_array_equal(t, r)
        assert tfm.injected == rfm.injected


def test_config_from_env(monkeypatch):
    monkeypatch.setenv(tfaults.ENV_SEED, "42")
    monkeypatch.setenv(tfaults.ENV_RESIDENT_BER, "1e-4")
    monkeypatch.setenv(tfaults.ENV_BER, "2e-5")
    monkeypatch.setenv(tfaults.ENV_RETENTION, "0.5")
    assert (tfaults.ENV_SEED, tfaults.ENV_BER, tfaults.ENV_RESIDENT_BER,
            tfaults.ENV_RETENTION) == (rfaults.ENV_SEED, rfaults.ENV_BER,
                                       rfaults.ENV_RESIDENT_BER,
                                       rfaults.ENV_RETENTION)
    cfg = tfaults.FaultConfig.from_env(raise_on_uncorrectable=True)
    rcfg = rfaults.FaultConfig.from_env(raise_on_uncorrectable=True)
    assert cfg.seed == 42 and cfg.resident_ber == 1e-4
    assert __import__("dataclasses").asdict(cfg) == \
        __import__("dataclasses").asdict(rcfg)
    assert tfaults.fault_seed() == 42
    monkeypatch.setenv(tfaults.ENV_SEED, "not-an-int")
    assert tfaults.fault_seed(default=7) == 7


def test_kill_bank_schedule():
    fm = tfaults.FaultModel(tfaults.FaultConfig(kill_bank_at=(3, 1)))
    fm.on_step(0)
    fm.on_step(2)
    assert fm.dead_banks == ()
    fm.on_step(3)
    assert fm.dead_banks == (1,) and fm.bank_kills == 1
    fm.on_step(4)                              # idempotent
    assert fm.bank_kills == 1


@pytest.fixture
def ref_lowering(monkeypatch):
    """The reference's lowering under JAX 0.9, for this test only."""
    monkeypatch.setattr(jax.core, "Literal", jex.Literal, raising=False)
    monkeypatch.setattr(jax.core, "Var", jex.Var, raising=False)


def test_lowered_and_scheduled_calls_inject_nothing(ref_lowering):
    """A lowered call and a schedule program under a streamed-BER campaign
    inject 0 bits in both packages (the reference's programs are jitted:
    their operands are tracers), so the next eager access draws the same
    bits in both: no PCG64 draw was spent on the programs."""
    from repro.cim import macro as rmacro
    from repro.cim.lower import lower as rlower
    from repro_torch.cim import macro as tmacro
    from repro_torch.cim.lower import lower as tlower

    rng = np.random.default_rng(9)
    a = rng.integers(-300, 300, size=64).astype(np.int16)
    b = rng.integers(-300, 300, size=64).astype(np.int16)
    m1 = rng.integers(-8, 8, size=(4, 16)).astype(np.int32)
    m2 = rng.integers(-8, 8, size=(16, 3)).astype(np.int32)

    def f(x, y):
        return x - y

    cfg = dict(seed=4, ber=0.05)
    _, _, (rpa, rpb), (tpa, tpb) = _packs()
    with rfaults.faults(rfaults.FaultConfig(**cfg)) as rfm:
        rl = np.asarray(rlower(f)(jnp.asarray(a), jnp.asarray(b)))
        rm = np.asarray(rmacro.matmul(jnp.asarray(m1), jnp.asarray(m2),
                                      n_bits=8))
        assert rfm.injected == 0
        r = np.asarray(rengine.execute(rpa, rpb, ("sub",))["sub"].unpack())
    with tfaults.faults(tfaults.FaultConfig(**cfg)) as tfm:
        tl = tlower(f)(torch.from_numpy(a), torch.from_numpy(b))
        tm = tmacro.matmul(torch.from_numpy(m1), torch.from_numpy(m2),
                           n_bits=8)
        assert tfm.injected == 0
        t = tengine.execute(tpa, tpb, ("sub",))["sub"].unpack().numpy()
    np.testing.assert_array_equal(tl.numpy(), a - b)
    np.testing.assert_array_equal(rl, a - b)
    np.testing.assert_array_equal(tm.numpy(), m1 @ m2)
    np.testing.assert_array_equal(rm, m1 @ m2)
    assert tfm.injected == rfm.injected > 0
    np.testing.assert_array_equal(t, r)


# ---------------------------------------------------------------------------
# ECC-protected resident operands
# ---------------------------------------------------------------------------


def _ecc_sets():
    return (rarray.ResidentSet(rarray.ArraySpec(**ECC_SPEC_KW),
                               reserve_rows=64, ecc=True),
            tarray.ResidentSet(tarray.ArraySpec(**ECC_SPEC_KW),
                               reserve_rows=64, ecc=True))


def test_pin_stores_parity_and_charges_ecc():
    rrs, trs = _ecc_sets()
    _, _, (rpack, _), (tpack, _) = _packs()
    re_ = rrs.pin(("w",), rpack, fingerprint=(1,))
    te = trs.pin(("w",), tpack, fingerprint=(1,))
    np.testing.assert_array_equal(_u32(te.ecc_parity), re_.ecc_parity)
    assert te.ecc_parity.shape[0] == tpp.ecc_plane_count(tpack.n_bits)
    assert te.rows_by_bank == re_.rows_by_bank
    # 13 rows a bank = 8 data + 5 parity planes per tile
    assert all(r == 13 for r in te.rows_by_bank.values())
    _ledgers_equal()
    n_tiles = tarray.ArraySpec(**ECC_SPEC_KW).plan(tpack.n_words).n_tiles
    assert TLEDGER.ecc_accesses == TLEDGER.load_accesses == n_tiles


@pytest.mark.parametrize("seed,ber", [(3, 2e-4), (0, 1e-3), (8, 5e-3)])
def test_get_corrects_single_bit_faults(seed, ber):
    rrs, trs = _ecc_sets()
    x, _, (rpack, _), (tpack, _) = _packs()
    rrs.pin(("w",), rpack, fingerprint=(1,))
    trs.pin(("w",), tpack, fingerprint=(1,))
    results = []
    for m, rs in ((rfaults, rrs), (tfaults, trs)):
        got = []
        with m.faults(m.FaultConfig(seed=seed, resident_ber=ber)) as fm:
            for _ in range(20):
                e = rs.get(("w",), fingerprint=(1,))
                got.append(None if e is None else np.asarray(
                    e.pack.unpack()))
        results.append((fm.stats(), rs.stats(), got))
    (rst, rrs_st, rgot), (tst, trs_st, tgot) = results
    assert tst == rst and trs_st == rrs_st
    for r, t in zip(rgot, tgot):
        assert (r is None) == (t is None)
        if t is not None:
            np.testing.assert_array_equal(t, r)
    if seed == 3:
        assert tst["injected"] > 0
        assert trs.ecc_corrected == tst["injected"]
        assert trs.ecc_uncorrected == 0
        assert all((t == x).all() for t in tgot)
    _ledgers_equal()


def test_uncorrectable_invalidates_and_misses():
    rrs, trs = _ecc_sets()
    _, _, (rpack, _), (tpack, _) = _packs()
    for m, rs, pack in ((rfaults, rrs, rpack), (tfaults, trs, tpack)):
        rs.pin(("w",), pack, fingerprint=(1,))
        cfg = m.FaultConfig(seed=0, uncorrectable_at_verify=(0,))
        with m.faults(cfg) as fm:
            assert rs.get(("w",), fingerprint=(1,)) is None
        assert fm.uncorrected == 1
        assert rs.invalidations == 1
        assert rs.get(("w",), fingerprint=(1,)) is None     # really gone
    assert trs.stats() == rrs.stats()
    _ledgers_equal()


def test_uncorrectable_raises_when_failstop():
    trs = _ecc_sets()[1]
    _, _, _, (tpack, _) = _packs()
    trs.pin(("w",), tpack, fingerprint=(1,))
    cfg = tfaults.FaultConfig(seed=0, uncorrectable_at_verify=(0,),
                              raise_on_uncorrectable=True)
    with tfaults.faults(cfg):
        with pytest.raises(tfaults.UncorrectableFaultError):
            trs.get(("w",), fingerprint=(1,))
    assert issubclass(tfaults.UncorrectableFaultError, CimOpError)
    # the entry was invalidated before raising: a re-pin recovers
    e = trs.pin(("w",), tpack, fingerprint=(1,))
    assert trs.get(("w",), fingerprint=(1,)) is e


@pytest.mark.parametrize("seed,rate,dt", [(5, 2.0, 2.0), (1, 40.0, 3.0),
                                          (2, 0.0, 5.0)])
def test_scrub_integrates_retention_decay(seed, rate, dt):
    """Retention decay over a fake clock: the scrub report, the counters
    and the surviving planes equal the reference's."""
    rrs, trs = _ecc_sets()
    x, _, (rpack, _), (tpack, _) = _packs()
    outs = []
    for m, rs, pack in ((rfaults, rrs, rpack), (tfaults, trs, tpack)):
        clk = [0.0]
        fm = m.FaultModel(m.FaultConfig(seed=seed, retention_per_s=rate),
                          clock=lambda: clk[0])
        with m.faults(fm):
            e = rs.pin(("w",), pack, fingerprint=(1,))
            assert e.scrubbed_s == 0.0
            clk[0] = dt
            rep = rs.scrub()
            assert rep["scanned"] == 1
            assert e.scrubbed_s == dt             # decay window reset
            got = rs.get(("w",), fingerprint=(1,))
            if got is not None:                   # survived (or repaired)
                assert (np.asarray(got.pack.unpack()) == x).all()
        outs.append((rep, fm.stats(), rs.stats(), got is None))
    assert outs[1] == outs[0]
    _ledgers_equal()


def test_unprotected_set_never_verifies():
    rs = tarray.ResidentSet(tarray.ArraySpec(**ECC_SPEC_KW), reserve_rows=64,
                            ecc=False)
    _, _, _, (tpack, _) = _packs()
    e = rs.pin(("w",), tpack)
    assert e.ecc_parity is None
    with tfaults.faults(tfaults.FaultConfig(seed=1, resident_ber=1e-3)):
        rs.get(("w",))
    assert rs.ecc_verifies == 0


def test_registry_default_ecc_toggle():
    spec = tarray.ArraySpec(**ECC_SPEC_KW)
    assert tarray.set_resident_ecc(True) is False
    try:
        assert tarray.resident_ecc_default()
        assert tarray.resident_set(spec).ecc
    finally:
        assert tarray.set_resident_ecc(False) is True
        tarray.clear_resident()
    assert not tarray.resident_set(spec).ecc


def test_ledger_fault_counters_and_reset():
    rrs, trs = _ecc_sets()
    _, _, (rpack, _), (tpack, _) = _packs()
    for m, rs, pack in ((rfaults, rrs, rpack), (tfaults, trs, tpack)):
        rs.pin(("w",), pack, fingerprint=(1,))
        with m.faults(m.FaultConfig(seed=0, uncorrectable_at_verify=(0,))):
            rs.get(("w",), fingerprint=(1,))
    _ledgers_equal()
    assert TLEDGER.fault_injected >= 2 and TLEDGER.fault_detected >= 1
    assert TLEDGER.fault_uncorrected == 1 and TLEDGER.ecc_accesses > 0
    TLEDGER.reset()
    assert TLEDGER.fault_injected == 0 and TLEDGER.ecc_accesses == 0
    assert TLEDGER.fault_uncorrected == 0 and TLEDGER.ecc_words32 == 0


def test_fault_stats_ride_cache_stats():
    _, _, (rpa, rpb), (tpa, tpb) = _packs()
    with rfaults.faults(rfaults.FaultConfig(seed=6, ber=1e-2)):
        rengine.execute(rpa, rpb, ("add",))
    with tfaults.faults(tfaults.FaultConfig(seed=6, ber=1e-2)):
        tengine.execute(tpa, tpb, ("add",))
    rs, ts = rdispatch.cache_stats(), tdispatch.cache_stats()
    for k in rfaults.fault_stats():
        assert ts[k] == rs[k], k
    for k in ("ecc_verifies", "ecc_corrected", "ecc_uncorrected",
              "ecc_scrubs"):
        assert ts[k] == rs[k] == 0, k


def test_fingerprint_mismatch_counts_invalidation():
    rs = tarray.ResidentSet(tarray.ArraySpec(**SPEC_KW))
    _, _, _, (tpack, _) = _packs(n=32)
    rs.pin(("w",), tpack, fingerprint=(1,))
    assert rs.get(("w",), fingerprint=(2,)) is None
    st = rs.stats()
    assert st["invalidations"] == 1 and st["misses"] == 1
    assert tarray.resident_stats()["resident_invalidations"] >= 1
    assert "resident_invalidations" in tdispatch.cache_stats()


# ---------------------------------------------------------------------------
# bank failover: dead-bank remapping
# ---------------------------------------------------------------------------


def test_disable_bank_validation():
    spec = tarray.ArraySpec(**SPEC_KW)
    deg = spec.disable_bank(0)
    assert deg.enabled_banks == (1,) and deg.n_enabled == 1
    with pytest.raises(CimOpError):
        deg.disable_bank(1)                 # nothing left to remap to
    with pytest.raises(CimOpError):
        tarray.ArraySpec(**SPEC_KW, disabled_banks=(5,))


def test_degraded_plan_skips_dead_banks():
    kw = dict(banks=4, subarrays=1, rows=64, bitline_words=32,
              disabled_banks=(1, 2))
    plan = tarray.ArraySpec(**kw).plan(4 * 32)
    rplan = rarray.ArraySpec(**kw).plan(4 * 32)
    assert plan.live_banks == rplan.live_banks == (0, 3)
    assert [plan.bank_of(t) for t in range(plan.n_tiles)] == \
        [rplan.bank_of(t) for t in range(rplan.n_tiles)]
    assert plan.waves == rplan.waves == 2
    assert plan.bank_counts(1) == rplan.bank_counts(1)


def test_remap_is_bit_exact():
    x, y, _, (tpa, tpb) = _packs()
    spec = tarray.ArraySpec(**SPEC_KW)
    healthy = tdispatch.execute_tiled(tpa, tpb, ("add", "lt"),
                                      spec=spec)["add"].unpack().numpy()
    remapped = tdispatch.execute_tiled(
        tpa, tpb, ("add", "lt"), spec=spec.disable_bank(0))[
        "add"].unpack().numpy()
    np.testing.assert_array_equal(healthy, remapped)
    np.testing.assert_array_equal(healthy, x + y)


def test_degraded_spec_is_distinct_cache_key():
    spec = tarray.ArraySpec(**SPEC_KW)
    deg = spec.disable_bank(1)
    assert deg != spec
    assert tarray.resident_set(spec) is not tarray.resident_set(deg)


def test_spec_override_routes_layers():
    assert tarray.spec_override() is None
    assert tarray.current_spec() == tarray.DEFAULT_SPEC
    deg = tarray.ArraySpec(**SPEC_KW).disable_bank(0)
    try:
        assert tarray.set_current_spec(deg) is None
        assert tarray.spec_override() == deg
        assert tarray.current_spec() == deg
    finally:
        tarray.set_current_spec(None)
    assert tarray.spec_override() is None


def _paged_pair(n_blocks=4, **rs_kw):
    from repro.launch.paged_kv import PagedKV as RPaged
    from repro_torch.launch.paged_kv import PagedKV as TPaged
    out = []
    for paged, arr in ((RPaged, rarray), (TPaged, tarray)):
        rs = arr.ResidentSet(arr.ArraySpec(**SPEC_KW), **rs_kw)
        out.append((paged(spec=arr.ArraySpec(**SPEC_KW), n_blocks=n_blocks,
                          block_tokens=4, kv_bits=8, resident_set=rs), rs))
    return out


def _rows(rs):
    return {k: e.rows_by_bank for k, e in rs._entries.items()}


def test_paged_kv_migrates_off_dead_bank():
    for (kv, rs), arr in zip(_paged_pair(), (rarray, tarray)):
        assert kv.alloc(0, 16)                  # all 4 blocks, banks 0+1
        assert set(rs.rows_per_bank()) == {0, 1}
        deg = arr.ArraySpec(**SPEC_KW).disable_bank(0)
        rs2 = arr.ResidentSet(deg)
        assert kv.migrate(deg, rs2) == 4
        assert set(rs2.rows_per_bank()) == {1}  # everything off bank 0
        assert len(rs) == 0                     # old claims released
        assert kv.spec == deg and kv.rs is rs2
        assert [kv.bank_of_block(b) for b in range(4)] == [1, 1, 1, 1]
        kv_rows = _rows(rs2)
        kv.free(0)
        assert len(rs2) == 0                    # lifecycle follows the move
    assert kv_rows == {("kv", b): {1: 8} for b in range(4)}


def test_paged_kv_migrate_rolls_back_on_failure():
    for (kv, rs), arr in zip(_paged_pair(), (rarray, tarray)):
        assert kv.alloc(0, 16)
        before = _rows(rs)
        deg = arr.ArraySpec(**SPEC_KW).disable_bank(0)
        # 4 blocks x 8 rows on one live bank = 32 rows, but only 24 fit
        rs_small = arr.ResidentSet(deg, reserve_rows=40)
        with pytest.raises(CimOpError if arr is tarray else Exception):
            kv.migrate(deg, rs_small)
        assert len(rs_small) == 0               # staged claims rolled back
        assert len(rs) == 4 and kv.spec == arr.ArraySpec(**SPEC_KW)
        assert _rows(rs) == before and kv.rs is rs


def test_paged_kv_places_new_blocks_on_live_banks():
    kw = dict(banks=4, subarrays=1, rows=64, bitline_words=32,
              disabled_banks=(1,))
    from repro.launch.paged_kv import PagedKV as RPaged
    from repro_torch.launch.paged_kv import PagedKV as TPaged
    r = RPaged(spec=rarray.ArraySpec(**kw), n_blocks=8)
    t = TPaged(spec=tarray.ArraySpec(**kw), n_blocks=8)
    assert [t.bank_of_block(b) for b in range(8)] == \
        [r.bank_of_block(b) for b in range(8)] == [0, 2, 3, 0, 2, 3, 0, 2]


def test_check_fits_respects_degraded_budget():
    deg = tarray.ArraySpec(banks=2, subarrays=1, rows=64, bitline_words=32,
                           disabled_banks=(0,))
    assert deg.parallel_words == 32         # one live bank
    plan = deg.plan(64)
    assert plan.n_tiles == 2 and plan.waves == 2


# ---------------------------------------------------------------------------
# the shared seed convention with the training supervisor
# ---------------------------------------------------------------------------


def _fail_steps(hook, n=20):
    from repro.runtime.supervisor import SimulatedHostFailure as RFail
    from repro_torch.runtime.supervisor import SimulatedHostFailure as TFail
    failed = []
    for step in range(n):
        try:
            hook(step)
        except (RFail, TFail):
            failed.append(step)
    return failed


def test_hook_fires_at_scheduled_steps_once():
    from repro_torch.runtime.supervisor import SimulatedHostFailure
    hook = tfaults.host_failure_hook(fail_steps=(2,))
    hook(0)
    hook(1)
    with pytest.raises(SimulatedHostFailure):
        hook(2)
    hook(2)                                 # replay after restart: clean
    hook(3)


@pytest.mark.parametrize("seed,p", [(123, 0.5), (0, 0.2), (7, 0.9)])
def test_hook_probabilistic_fires_as_the_reference(seed, p):
    """The same (seed, step) draws: the port's hook fails at exactly the
    reference's steps, and again in an identical campaign."""
    t = _fail_steps(tfaults.host_failure_hook(p_fail=p, seed=seed))
    assert t == _fail_steps(rfaults.host_failure_hook(p_fail=p, seed=seed))
    assert t == _fail_steps(tfaults.host_failure_hook(p_fail=p, seed=seed))
    if p >= 0.5:
        assert t


def test_hook_seed_env_convention(monkeypatch):
    from repro_torch.runtime.supervisor import SimulatedHostFailure
    monkeypatch.setenv(tfaults.ENV_SEED, "99")
    hook = tfaults.host_failure_hook(p_fail=1.0)
    with pytest.raises(SimulatedHostFailure, match="seed 99"):
        hook(0)


def test_supervisor_recovers_from_hook(tmp_path):
    """A Supervisor driven by the shared-seed hook restarts through the
    injected failure and finishes the run: the hook fires once, so the
    restart's replay of the same step is clean."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.runtime.supervisor import Supervisor, SupervisorConfig

    def step_fn(st, batch):
        return ({"step": st["step"] + 1, "value": st["value"] + batch},
                {"loss": torch.tensor(1.0)})

    hook = tfaults.host_failure_hook(fail_steps=(3,), seed=7)
    sup = Supervisor(step_fn, lambda s: torch.tensor(1.0),
                     CheckpointManager(str(tmp_path), keep=2),
                     SupervisorConfig(ckpt_every=2, max_restarts=4),
                     fault_hook=hook)
    state0 = {"step": torch.tensor(0, dtype=torch.int32),
              "value": torch.tensor(0.0)}
    final, _ = sup.run(state0, 6)
    assert len(sup.events) == 1 and sup.events[0]["step"] == 3
    assert int(final["step"]) == 6 and float(final["value"]) == 6.0


# ---------------------------------------------------------------------------
# cost model: ECC overhead weighed by the offload policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_bits", [1, 4, 8, 16, 32])
def test_ecc_overhead_matches_reference(n_bits):
    from repro.cim import cost as rcost
    from repro_torch.cim import cost as tcost
    assert tcost.ecc_overhead(n_bits) == rcost.ecc_overhead(n_bits)


def test_ecc_overhead_ratio_scales_load_cost(ref_lowering):
    from repro.cim import accounting as racc
    from repro.cim import cost as rcost
    from repro.cim.trace import trace as rtrace
    from repro_torch.cim import accounting as tacc
    from repro_torch.cim import cost as tcost
    from repro_torch.cim.trace import trace as ttrace

    rtr = rtrace(lambda a, b: a + b, np.zeros(64, np.int16),
                       np.ones(64, np.int16))
    ttr = ttrace(lambda a, b: a + b, torch.zeros(64, dtype=torch.int16),
                       torch.ones(64, dtype=torch.int16))
    rop = next(o for o in rtr.ops if o.eligible and o.accesses > 0)
    top = next(o for o in ttr.ops if o.eligible and o.accesses > 0)
    rres = racc._SCHEMES["current"](1024)
    tres = tacc._SCHEMES["current"](1024)
    dev = rcost.DeviceSpec.from_dict(tcost.DEFAULT_DEVICE.to_dict())
    out = []
    for cost, op, res, device in ((rcost, rop, rres, dev),
                                  (tcost, top, tres, tcost.DEFAULT_DEVICE)):
        plain = cost.project_eqn(op, 0, None, res, device, "edp")
        prot = cost.project_eqn(op, 0, None, res, device, "edp",
                                ecc_overhead_ratio=cost.ecc_overhead(
                                    op.n_bits))
        assert prot.load_words32 > plain.load_words32
        assert prot.cim_energy > plain.cim_energy
        out.append((plain.load_words32, prot.load_words32, plain.cim_energy,
                    prot.cim_energy, prot.lowers))
    assert out[1] == out[0]
    assert tcost.ecc_overhead(8) == pytest.approx(5 / 8)
    assert tcost.ecc_overhead(16) == pytest.approx(6 / 16)


def test_plan_offload_pays_parity_while_pins_are_protected():
    """With registry ECC on, every eligible op that loads operands costs
    more CiM energy; free ops (n_bits 0 in the aten capture) pay nothing."""
    from repro_torch.cim import cost as tcost
    from repro_torch.cim.trace import trace as ttrace

    def f(a, b):
        return (a + b).reshape(8, 8) - b.reshape(8, 8)

    tr = ttrace(f, torch.zeros(64, dtype=torch.int16),
                      torch.ones(64, dtype=torch.int16))
    plain = tcost.plan_offload(tr)
    tarray.set_resident_ecc(True)
    try:
        prot = tcost.plan_offload(tr)
    finally:
        tarray.set_resident_ecc(False)
    assert len(prot.verdicts) == len(plain.verdicts) > 0
    for v, w in zip(plain.verdicts, prot.verdicts):
        if v.load_words32 > 0:
            assert w.cim_energy > v.cim_energy
        else:
            assert w.cim_energy == v.cim_energy
