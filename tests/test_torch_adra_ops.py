"""The port's ADRA op surface and sampler against the reference's.

`repro_torch.kernels` (`adra_bitplane_op`, `baseline_bitplane_sub_then_cmp`,
`ops.adra_sub`/`adra_add`/`baseline_sub_then_cmp`, `cim_matmul`,
`cim_relu`, `cim_lower`, `unpack_bits_mask`, the traffic model and the
`ref` oracles) on the cases of tests/test_kernels.py, and
`repro_torch.train.adra_sample` against the reference's tokens and against
the accesses and loads of the reference's level written with
`jax.lax.select` (under JAX 0.9 its `jnp.where` stays a host eqn, so the
reference itself charges half the loads: ROADMAP C). Integer results are
exact (tolerance 0); the reference runs its Pallas kernel in interpret
mode. The `cuda`-marked cases need the card and skip here.
"""
import jax
import jax.extend.core as jex
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bitplane import pack_bitplanes as rpack
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.adra_bitplane import adra_bitplane_op as r_bitplane_op
from repro.kernels.adra_bitplane import traffic_model_bytes as r_traffic
from repro_torch.cim import dispatch as tdisp
from repro_torch.cim.accounting import LEDGER as TLEDGER
from repro_torch.cim.array import ArraySpec
from repro_torch.cim.opset import CimOpError
from repro_torch.core.bitplane import pack_bitplanes as tpack
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.adra_bitplane import (adra_bitplane_op,
                                               baseline_bitplane_sub_then_cmp,
                                               traffic_model_bytes)
from repro_torch.train import step as tstep

RNG = np.random.RandomState(42)


@pytest.fixture(autouse=True)
def _fresh():
    TLEDGER.reset()
    tdisp.clear_schedule_cache()
    yield
    TLEDGER.reset()
    tdisp.clear_schedule_cache()


@pytest.fixture
def ref_lowering(monkeypatch):
    """The reference's lowering under JAX 0.9, for this test only."""
    monkeypatch.setattr(jax.core, "Literal", jex.Literal, raising=False)
    monkeypatch.setattr(jax.core, "Var", jex.Var, raising=False)


def _u32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.numpy().view(np.uint32)
    return np.asarray(t, dtype=np.uint32)


def _ints(lo, hi, n, rng=RNG):
    return rng.randint(lo, hi, n).astype(np.int32)


# ---------------------------------------------------------------------------
# adra_bitplane shims and oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_bits", [4, 8, 16, 32])
@pytest.mark.parametrize("n", [32, 100, 1000])
@pytest.mark.parametrize("select", [0, 1])
def test_adra_bitplane_matches_plane_oracle(n_bits, n, select):
    lo, hi = -(2 ** (n_bits - 1)), 2 ** (n_bits - 1) - 1
    rng = np.random.RandomState(n_bits * 10000 + n * 10 + select)
    a, b = _ints(lo, hi, n, rng), _ints(lo, hi, n, rng)
    ap, bp = tpack(torch.from_numpy(a), n_bits), \
        tpack(torch.from_numpy(b), n_bits)
    got = adra_bitplane_op(ap, bp, select=select)
    want = tref.adra_bitplane_ref(ap, bp, select=select)
    rap, rbp = rpack(jnp.asarray(a), n_bits), rpack(jnp.asarray(b), n_bits)
    rwant = rref.adra_bitplane_ref(rap, rbp, select=select)
    assert len(got) == len(want) == len(rwant) == 4
    for g, w, rw in zip(got, want, rwant):
        np.testing.assert_array_equal(_u32(g), _u32(w))
        np.testing.assert_array_equal(_u32(g), np.asarray(rw))
    if n == 100:
        # the reference's own kernel (Pallas, interpret mode) once a width
        for g, rg in zip(got, r_bitplane_op(rap, rbp, select=select,
                                            interpret=True)):
            np.testing.assert_array_equal(_u32(g), np.asarray(rg))


@pytest.mark.parametrize("n_bits", [8, 16])
def test_adra_bitplane_int_semantics(n_bits):
    lo, hi = -(2 ** (n_bits - 1)), 2 ** (n_bits - 1) - 1
    rng = np.random.RandomState(n_bits)
    a, b = _ints(lo, hi, 500, rng), _ints(lo, hi, 500, rng)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    d, lt, eq = tops.adra_sub(ta, tb, n_bits=n_bits)
    rd, rlt, req = rops.adra_sub(jnp.asarray(a), jnp.asarray(b),
                                 n_bits=n_bits, interpret=True)
    for g, r in ((d, rd), (lt, rlt), (eq, req)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(d.numpy(), a - b)
    np.testing.assert_array_equal(lt.numpy(), (a < b).astype(np.int32))
    np.testing.assert_array_equal(eq.numpy(), (a == b).astype(np.int32))
    s = tops.adra_add(ta, tb, n_bits=n_bits + 1)
    np.testing.assert_array_equal(s.numpy(), a + b)
    np.testing.assert_array_equal(
        s.numpy(), np.asarray(rops.adra_add(jnp.asarray(a), jnp.asarray(b),
                                            n_bits=n_bits + 1,
                                            interpret=True)))


@pytest.mark.parametrize("case", range(12))
def test_adra_bitplane_property(case):
    """The reference's property sweep (n_bits 2-12, n 1-200, add or sub)
    as seeded cases: exact integer results, equal to the reference's (its
    plain plane math: the interpret-mode kernel is held above)."""
    pick = np.random.RandomState(7000 + case)
    n_bits, n, sub = int(pick.randint(2, 13)), int(pick.randint(1, 201)), \
        bool(pick.randint(0, 2))
    lo, hi = -(2 ** (n_bits - 1)), 2 ** (n_bits - 1) - 1
    rng = np.random.RandomState(n_bits * 1000 + n)
    a, b = _ints(lo, hi + 1, n, rng), _ints(lo, hi + 1, n, rng)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if sub:
        d, _, _ = tops.adra_sub(ta, tb, n_bits=n_bits)
        np.testing.assert_array_equal(d.numpy(), a - b)
        rd, _, _ = rops.adra_sub(jnp.asarray(a), jnp.asarray(b),
                                 n_bits=n_bits, backend="jnp-boolean")
        np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
    else:
        s = tops.adra_add(ta, tb, n_bits=n_bits)
        np.testing.assert_array_equal(s.numpy(), a + b)
        rs = rops.adra_add(jnp.asarray(a), jnp.asarray(b), n_bits=n_bits,
                           backend="jnp-boolean")
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))


def test_baseline_two_pass_matches_fused():
    rng = np.random.RandomState(3)
    a, b = _ints(-1000, 1000, 300, rng), _ints(-1000, 1000, 300, rng)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    TLEDGER.reset()
    d1, l1, e1 = tops.adra_sub(ta, tb, n_bits=16)
    fused_accesses = TLEDGER.accesses
    TLEDGER.reset()
    d2, l2, e2 = tops.baseline_sub_then_cmp(ta, tb, n_bits=16)
    assert (fused_accesses, TLEDGER.accesses) == (1, 2)
    rd, rl, re_ = rops.baseline_sub_then_cmp(jnp.asarray(a), jnp.asarray(b),
                                             n_bits=16, interpret=True)
    for x, y, r in ((d1, d2, rd), (l1, l2, rl), (e1, e2, re_)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
        np.testing.assert_array_equal(x.numpy(), np.asarray(r))


def test_baseline_bitplane_shim_is_two_passes_of_the_fused_one():
    rng = np.random.RandomState(4)
    a, b = _ints(-500, 500, 257, rng), _ints(-500, 500, 257, rng)
    ap, bp = tpack(torch.from_numpy(a), 16), tpack(torch.from_numpy(b), 16)
    sum_p, lt, eq = baseline_bitplane_sub_then_cmp(ap, bp)
    f_sum, _, f_lt, f_eq = adra_bitplane_op(ap, bp, select=1)
    for g, w in ((sum_p, f_sum), (lt, f_lt), (eq, f_eq)):
        np.testing.assert_array_equal(_u32(g), _u32(w))


@pytest.mark.parametrize("n_bits,n_words32", [(16, 4096), (8, 1), (29, 333)])
def test_traffic_model_single_vs_two_pass(n_bits, n_words32):
    t = traffic_model_bytes(n_bits=n_bits, n_words32=n_words32)
    assert t == r_traffic(n_bits=n_bits, n_words32=n_words32)
    assert t["baseline"] > t["fused"]
    if n_bits == 16:
        assert t["ratio"] > 1.4


@pytest.mark.parametrize("select", [0, 1])
def test_adra_int_ref_matches_reference(select):
    rng = np.random.RandomState(5 + select)
    a, b = _ints(-2 ** 15, 2 ** 15, 400, rng), _ints(-2 ** 15, 2 ** 15, 400,
                                                     rng)
    got = tref.adra_int_ref(torch.from_numpy(a), torch.from_numpy(b),
                            select, 16)
    want = rref.adra_int_ref(jnp.asarray(a), jnp.asarray(b), select, 16)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unpack_bits_mask_matches_reference():
    rng = np.random.RandomState(8)
    bitmap = rng.randint(0, 2 ** 32, size=(1, 5), dtype=np.uint64) \
        .astype(np.uint32)
    got = tops.unpack_bits_mask(torch.from_numpy(bitmap.view(np.int32)), 150)
    want = rops.unpack_bits_mask(jnp.asarray(bitmap), 150)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_interpret_flag_raises_and_false_pins_the_kernel():
    a = torch.arange(8, dtype=torch.int32)
    with pytest.raises(CimOpError, match="interpret"):
        tops.adra_sub(a, a, interpret=True)
    with pytest.raises(CimOpError, match="interpret"):
        adra_bitplane_op(tpack(a, 8), tpack(a, 8), select=1, interpret=True)
    assert tops._resolve_backend(False, None) == "fused"
    assert tops._resolve_backend(None, None) is None
    assert tops._resolve_backend(False, "torch-boolean") == "torch-boolean"
    d, lt, eq = tops.adra_sub(a, a.flip(0), interpret=False)
    np.testing.assert_array_equal(d.numpy(), (a - a.flip(0)).numpy())


def test_banked_adra_sub_charges_per_tile():
    rng = np.random.RandomState(9)
    a, b = _ints(-100, 100, 256, rng), _ints(-100, 100, 256, rng)
    spec = ArraySpec(banks=2, subarrays=1, rows=64, bitline_words=32)
    d, lt, _ = tops.adra_sub(torch.from_numpy(a), torch.from_numpy(b),
                             n_bits=8, spec=spec)
    np.testing.assert_array_equal(d.numpy(), a - b)
    np.testing.assert_array_equal(lt.numpy(), (a < b).astype(np.int32))
    assert TLEDGER.accesses == spec.plan(256).n_tiles
    with pytest.raises(CimOpError, match="no 'data'"):
        tops.cim_relu(torch.from_numpy(a), spec=spec, mesh=object())


# ---------------------------------------------------------------------------
# macro ops and the lowering entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n,n_bits", [(4, 16, 3, 8), (2, 33, 5, 6),
                                          (1, 7, 1, 4)])
def test_cim_matmul_matches_reference(m, k, n, n_bits):
    rng = np.random.RandomState(m * 100 + k)
    lim = 2 ** (n_bits - 1)
    a = rng.randint(-lim, lim, size=(m, k)).astype(np.int32)
    b = rng.randint(-lim, lim, size=(k, n)).astype(np.int32)
    got = tops.cim_matmul(torch.from_numpy(a), torch.from_numpy(b),
                          n_bits=n_bits)
    np.testing.assert_array_equal(got.numpy(), a @ b)
    want = rops.cim_matmul(jnp.asarray(a), jnp.asarray(b), n_bits=n_bits,
                           backend="jnp-boolean")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tdisp.cache_stats()["dispatches"] == 1


@pytest.mark.parametrize("n_bits", [4, 9, 16])
def test_cim_relu_matches_reference(n_bits):
    rng = np.random.RandomState(n_bits)
    lim = 2 ** (n_bits - 1)
    x = rng.randint(-lim, lim, size=(3, 37)).astype(np.int32)
    got = tops.cim_relu(torch.from_numpy(x), n_bits=n_bits)
    np.testing.assert_array_equal(got.numpy(), np.maximum(x, 0))
    want = rops.cim_relu(jnp.asarray(x), n_bits=n_bits,
                         backend="jnp-boolean")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert TLEDGER.accesses == 1


def test_kernels_ops_cim_lower_entry_point(ref_lowering):
    def fn(a, b):
        return torch.clamp_min(a - b, 0)

    a = torch.tensor([5, -3, 9, 0], dtype=torch.int16)
    b = torch.tensor([1, 2, 30, 0], dtype=torch.int16)
    lf = tops.cim_lower(fn, backend="torch-boolean")
    np.testing.assert_array_equal(lf(a, b).numpy(), fn(a, b).numpy())
    rlf = rops.cim_lower(lambda x, y: jnp.maximum(x - y, 0),
                         backend="jnp-boolean")
    np.testing.assert_array_equal(
        lf(a, b).numpy(), np.asarray(rlf(jnp.asarray(a.numpy()),
                                         jnp.asarray(b.numpy()))))
    assert TLEDGER.accesses > 0


# ---------------------------------------------------------------------------
# the ADRA sampler
# ---------------------------------------------------------------------------


def _select_level(a, b, ia, ib):
    """The reference's level written with jax.lax.select, which its
    lowering fuses into the access under JAX 0.9 (its jnp.where does not)."""
    take_b = a < b
    return jax.lax.select(take_b, b, a), jax.lax.select(take_b, ib, ia)


def _reference_sample(logits: np.ndarray, twin: bool, monkeypatch):
    """The reference's adra_sample on `logits`: tokens, accesses, loads,
    per_op (with its own level, or the lax.select twin's)."""
    import repro.train.step as rstep
    from repro.cim.accounting import LEDGER as RLEDGER

    monkeypatch.setattr(rstep, "_ADRA_LEVEL_LOWERED", None)
    if twin:
        monkeypatch.setattr(rstep, "_adra_level", _select_level)
    RLEDGER.reset()
    toks = np.asarray(rstep.adra_sample(jnp.asarray(logits)))
    out = (toks, RLEDGER.accesses, RLEDGER.load_accesses,
           dict(RLEDGER.per_op))
    monkeypatch.setattr(rstep, "_ADRA_LEVEL_LOWERED", None)
    return out


def _port_sample(logits: np.ndarray, n_bits: int = 8):
    TLEDGER.reset()
    d0 = tdisp.cache_stats()["dispatches"]
    toks = tstep.adra_sample(torch.from_numpy(logits), n_bits=n_bits)
    assert toks.dtype == torch.int32
    return (toks.numpy(), TLEDGER.accesses, TLEDGER.load_accesses,
            dict(TLEDGER.per_op), tdisp.cache_stats()["dispatches"] - d0)


def test_adra_sample_levels_lower_to_single_access(ref_lowering,
                                                   monkeypatch):
    """The reference test's input: [4, 33] logits whose last 3 columns are
    masked. Tokens are the argmax [0, 21, 3, 0]; six levels, one access
    and one dispatch each; 24 loads, as the lax.select twin charges (the
    reference's jnp.where level charges 12 under JAX 0.9)."""
    rng = np.random.RandomState(3)
    logits = rng.randn(4, 33).astype(np.float32)
    logits[:, -3:] = -1e30
    toks, acc, loads, per_op, disp = _port_sample(logits)
    np.testing.assert_array_equal(toks, np.argmax(logits, -1))
    assert toks.tolist() == [0, 21, 3, 0]
    assert (acc, loads, per_op, disp) == (6, 24, {"lt": 6}, 6)
    r_toks, r_acc, r_loads, r_per_op = _reference_sample(logits, False,
                                                         monkeypatch)
    np.testing.assert_array_equal(toks, r_toks)
    assert (r_acc, r_loads, r_per_op) == (6, 12, {"lt": 6})
    t_toks, t_acc, t_loads, t_per_op = _reference_sample(logits, True,
                                                         monkeypatch)
    np.testing.assert_array_equal(toks, t_toks)
    assert (acc, loads, per_op) == (t_acc, t_loads, t_per_op)


@pytest.mark.parametrize("shape,n_bits,masked", [
    ((3, 100), 8, 4), ((1, 5, 17), 8, 1), ((2, 130), 15, 0), ((2, 9), 16, 0)])
def test_adra_sample_matches_reference(ref_lowering, monkeypatch, shape,
                                       n_bits, masked):
    """Tokens equal to `adra_sample_ref` and to the reference's (through
    its lax.select twin level, whose tokens its jnp.where level shares);
    accesses, loads and per-op counts equal to the twin's; ceil(log2 V)
    levels of one access each; int32 indices (int16 words up to 15 bits,
    int32 at 16)."""
    rng = np.random.RandomState(sum(shape) + n_bits)
    logits = rng.randn(*shape).astype(np.float32) * 3
    if masked:
        logits[..., -masked:] = -1e30
    logits[..., 1] = logits[..., 0]            # a tie: the earlier wins
    toks, acc, loads, per_op, disp = _port_sample(logits, n_bits)
    plain = tstep.adra_sample_ref(torch.from_numpy(logits), n_bits=n_bits)
    np.testing.assert_array_equal(toks, plain.numpy())
    levels = int(np.ceil(np.log2(shape[-1])))
    assert acc == disp == levels and per_op == {"lt": levels}
    import repro.train.step as rstep
    from repro.cim.accounting import LEDGER as RLEDGER
    monkeypatch.setattr(rstep, "_ADRA_LEVEL_LOWERED", None)
    monkeypatch.setattr(rstep, "_adra_level", _select_level)
    RLEDGER.reset()
    r = np.asarray(rstep.adra_sample(jnp.asarray(logits), n_bits=n_bits))
    np.testing.assert_array_equal(toks, r)
    assert (RLEDGER.accesses, RLEDGER.load_accesses,
            dict(RLEDGER.per_op)) == (acc, loads, per_op)
    monkeypatch.setattr(rstep, "_ADRA_LEVEL_LOWERED", None)


def test_adra_sample_ref_ties_and_quantization():
    """The plain version quantizes as the sampler does: values within one
    quantization step tie, and ties keep the earliest index."""
    logits = torch.tensor([[0.0, 1.0, 1.0 + 1e-4, -1e30],
                           [2.0, 2.0, 2.0, 2.0]])
    assert tstep.adra_sample_ref(logits).tolist() == [1, 0]
    assert tstep.adra_sample(logits).tolist() == [1, 0]
    assert tstep._adra_quantize(logits, 8).dtype == torch.int16
    assert tstep._adra_quantize(logits, 16).dtype == torch.int32


@pytest.mark.cuda
def test_cuda_adra_sub_one_launch_against_baseline_two():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.cim import fused_kernel
    rng = np.random.RandomState(0)
    a, b = _ints(-2 ** 15, 2 ** 15, 1 << 16, rng), \
        _ints(-2 ** 15, 2 ** 15, 1 << 16, rng)
    ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    want = tref.adra_int_ref(ta, tb, 1, 16)
    n0 = fused_kernel.fused_planes_op.launches
    got = tops.adra_sub(ta, tb, n_bits=16)
    n1 = fused_kernel.fused_planes_op.launches
    base = tops.baseline_sub_then_cmp(ta, tb, n_bits=16)
    assert (n1 - n0, fused_kernel.fused_planes_op.launches - n1) == (1, 2)
    for g, bs, w in zip(got, base, want):
        assert torch.equal(g, w) and torch.equal(bs, w)


@pytest.mark.cuda
def test_cuda_adra_sample_equals_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    logits = torch.randn(2, 4099, generator=torch.Generator().manual_seed(1))
    got = tstep.adra_sample(logits.cuda())
    assert torch.equal(got.cpu(), tstep.adra_sample_ref(logits))
