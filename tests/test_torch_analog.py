"""Port vs reference: the analog-oracle backend (`repro_torch.cim.backends`),
the FeFET device model evaluated per bit behind the engine, the tiling
dispatcher, the macros and the lowering compiler.

The analog-oracle parametrisations of `tests/test_cim_engine.py` (parity,
all 16 Boolean functions, one fused access, unsigned operands, the
registry, the default-backend override), `tests/test_cim_macro.py`,
`tests/test_cim_property.py:106,187` at small widths,
`tests/test_cim_array.py:77` and `tests/test_cim_lower.py:318`, each run on
the port and held against numpy's integers and the reference's own
analog-oracle run on the same numpy inputs: planes, values and ledger
counts exact. Beside them: the backend on [T, n, W] tile stacks, on
non-contiguous views and over several lane chunks, equal to the bit to the
fused kernel's plain version and to the reference's backend.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import HealthCheck, given, settings, st

from repro import cim as rcim
from repro.cim import PlanePack as RPack
from repro.cim import backends as rbk
from repro.cim import dispatch as rdisp
from repro.cim import macro as rmacro
from repro.cim.accounting import LEDGER as RLEDGER
from repro_torch import cim
from repro_torch.cim import PlanePack, backends, dispatch, macro, opset, planner
from repro_torch.cim.accounting import LEDGER
from repro_torch.cim.array import ArraySpec
from repro_torch.cim.fused_kernel import fused_planes_op_ref
from repro_torch.cim.lower import lower
from repro_torch.models import layers as tlayers

BK = "analog-oracle"
RNG = np.random.RandomState(7)
_PROP = dict(max_examples=25, deadline=None,
             suppress_health_check=[HealthCheck.function_scoped_fixture])


@pytest.fixture(autouse=True)
def _fresh_state():
    for clear in (LEDGER.reset, RLEDGER.reset, dispatch.clear_schedule_cache):
        clear()
    yield
    LEDGER.reset()
    dispatch.clear_schedule_cache()
    tlayers._LOWERED_MLP.clear()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _pair(n_bits, n, rng=RNG):
    lo, hi = -(2 ** (n_bits - 1)), 2 ** (n_bits - 1)
    return (rng.randint(lo, hi, n).astype(np.int32),
            rng.randint(lo, hi, n).astype(np.int32))


def _planes(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _same_planes(got, want):
    """Port int32 planes against uint32 patterns (numpy or jax)."""
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


# ---------------------------------------------------------------------------
# the backend itself: layouts, views, chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_bits,w", [(1, 3), (5, 7), (9, 33)])
def test_backend_equals_reference_backend_on_every_op(n_bits, w):
    """Random planes (every bit pattern, not only packed integers): every op
    of the catalogue in one access, equal to the bit to the reference's
    analog-oracle and to the fused kernel's plain version."""
    a, b = _planes(n_bits, (n_bits, w)), _planes(n_bits + 100, (n_bits, w))
    ta, tb = _t(a.view(np.int32)), _t(b.view(np.int32))
    got = backends.get_backend(BK)(ta, tb, opset.ALL_OPS)
    want = rbk.get_backend(BK)(jnp.asarray(a), jnp.asarray(b), opset.ALL_OPS)
    plain = fused_planes_op_ref(ta, tb, opset.ALL_OPS)
    for op, g, r, p in zip(opset.ALL_OPS, got, want, plain):
        assert g.shape == (opset.out_rows(op, n_bits), w) and \
            g.dtype == torch.int32, op
        _same_planes(g, r)
        assert torch.equal(g, p), op


def test_backend_on_tile_stacks_and_views():
    """[T, n, W] stacks give [T, rows, W] outputs, tile by tile equal to
    the [n, W] call; a non-contiguous view computes what its copy does."""
    a, b = (_t(_planes(s, (3, 6, 20)).view(np.int32)) for s in (1, 2))
    ops = ("add", "lt", "carry_sub", "not_a_and_b")
    got = backends.get_backend(BK)(a, b, ops)
    for op, g, p in zip(ops, got, fused_planes_op_ref(a, b, ops)):
        assert g.shape == (3, opset.out_rows(op, 6), 20) and g.is_contiguous()
        assert torch.equal(g, p), op
    for t in range(3):
        for g, tile in zip(got, backends.get_backend(BK)(a[t], b[t], ops)):
            assert torch.equal(g[t], tile)
    for va, vb in ((a[1, :, ::2], b[1, :, ::2]),         # [6, 10]
                   (a[:, :, 3:17], b[:, :, 3:17])):     # [3, 6, 14]
        assert not va.is_contiguous()
        for g, w in zip(backends.get_backend(BK)(va, vb, ops),
                        backends.get_backend(BK)(va.contiguous(),
                                                 vb.contiguous(), ops)):
            assert torch.equal(g, w)


def test_chunked_lanes_change_no_result(monkeypatch):
    """Chunks of 1, 2 and 3 lanes (a ragged last chunk) give the one-chunk
    result."""
    a, b = (_t(_planes(s, (4, 11)).view(np.int32)) for s in (3, 4))
    whole = backends.get_backend(BK)(a, b, opset.ALL_OPS)
    for lanes in (1, 2, 3):
        monkeypatch.setattr(backends, "ANALOG_CHUNK_BITS", 32 * 4 * lanes)
        for g, w in zip(backends.get_backend(BK)(a, b, opset.ALL_OPS), whole):
            assert torch.equal(g, w)


def test_backend_rejects_malformed_requests():
    a = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(opset.CimOpError):
        backends.get_backend(BK)(a, torch.zeros((4, 9), dtype=torch.int32),
                                 ("add",))
    with pytest.raises(opset.CimOpError):
        backends.get_backend(BK)(a, a, ("add", "add"))


# ---------------------------------------------------------------------------
# engine parity (tests/test_cim_engine.py, the analog-oracle cases)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_bits,n", [(4, 48), (8, 70)])
def test_add_sub_compare_parity(n_bits, n):
    a, b = _pair(n_bits, n)
    ta, tb = _t(a), _t(b)
    np.testing.assert_array_equal(cim.add(ta, tb, n_bits, backend=BK).numpy(),
                                  a + b)
    np.testing.assert_array_equal(cim.sub(ta, tb, n_bits, backend=BK).numpy(),
                                  a - b)
    c = cim.compare(ta, tb, n_bits, backend=BK)
    rc = rcim.compare(jnp.asarray(a), jnp.asarray(b), n_bits, backend=BK)
    for g, r, want in zip(c, rc, (a < b, a == b, a > b)):
        np.testing.assert_array_equal(g.numpy(), want.astype(np.int32))
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("fn", opset.BOOLEAN_OPS)
def test_all_16_boolean_functions(fn):
    v = np.arange(16, dtype=np.int32)
    a, b = (x.ravel() for x in np.meshgrid(v, v, indexing="ij"))
    got = cim.boolean(_t(a), _t(b), fn, 4, backend=BK)
    want = rcim.boolean(jnp.asarray(a), jnp.asarray(b), fn, 4, backend=BK)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), cim.boolean(_t(a), _t(b), fn, 4,
                                 backend="torch-boolean").numpy())


def test_fused_multi_op_single_access():
    """Boolean + sub + compare + carries, ONE access: planes and ledger
    equal to the reference's analog-oracle access."""
    a, b = _pair(8, 64)
    ops = ("xor", "sub", "add", "lt", "eq", "gt", "carry_add", "carry_sub")
    out = cim.execute(PlanePack.pack(_t(a), 8), PlanePack.pack(_t(b), 8), ops,
                      backend=BK)
    rout = rcim.execute(RPack.pack(jnp.asarray(a), 8),
                        RPack.pack(jnp.asarray(b), 8), ops, backend=BK)
    np.testing.assert_array_equal(out["sub"].unpack().numpy(), a - b)
    np.testing.assert_array_equal(out["add"].unpack().numpy(), a + b)
    for op in ops:
        _same_planes(out[op].planes, rout[op].planes)
    assert LEDGER.accesses == RLEDGER.accesses == 1
    assert LEDGER.per_op == RLEDGER.per_op


def test_unsigned_operands_not_misread_as_negative():
    a = np.array([0, 255, 200, 7], np.int32)
    b = np.array([200, 1, 200, 255], np.int32)
    out = cim.execute(PlanePack.pack(_t(a), 8, signed=False),
                      PlanePack.pack(_t(b), 8, signed=False),
                      ("sub", "add", "lt", "eq", "gt"), backend=BK)
    for op, want in (("sub", a - b), ("add", a + b), ("lt", a < b),
                     ("eq", a == b), ("gt", a > b)):
        np.testing.assert_array_equal(out[op].unpack().numpy(),
                                      want.astype(np.int32))


# ---------------------------------------------------------------------------
# registry and resolution
# ---------------------------------------------------------------------------


def test_backend_registry_contents_and_errors():
    names = cim.available_backends()
    for required in ("fused", "torch-boolean", "analog-oracle"):
        assert required in names
    assert "analog-oracle" in rcim.available_backends()
    with pytest.raises(KeyError):
        cim.get_backend("no-such-backend")
    with pytest.raises(ValueError):
        cim.execute(PlanePack.pack(torch.arange(4), 4),
                    PlanePack.pack(torch.arange(4), 4), ("bogus-op",))


def test_default_backend_env_override(monkeypatch):
    """explicit argument > REPRO_TORCH_CIM_BACKEND > set_default_backend >
    "fused", as the reference orders its own."""
    monkeypatch.delenv(backends.ENV_VAR, raising=False)
    assert cim.default_backend_name() == "fused"
    monkeypatch.setenv(backends.ENV_VAR, "torch-boolean")
    assert cim.default_backend_name() == "torch-boolean"
    monkeypatch.delenv(backends.ENV_VAR)
    cim.set_default_backend("analog-oracle")
    try:
        assert cim.default_backend_name() == "analog-oracle"
        assert cim.get_backend().name == "analog-oracle"
        assert cim.get_backend("fused").name == "fused"
        monkeypatch.setenv(backends.ENV_VAR, "torch-boolean")
        assert cim.get_backend().name == "torch-boolean"
        with pytest.raises(KeyError):
            cim.set_default_backend("pallas-tpu")
        assert cim.default_backend_name() == "torch-boolean"
    finally:
        cim.set_default_backend(None)
    monkeypatch.delenv(backends.ENV_VAR)
    assert cim.default_backend_name() == "fused"


def test_default_backend_reaches_the_device_model(monkeypatch):
    """With no explicit backend, the set default is what the engine runs."""
    calls = []
    real = backends._analog_chunk
    monkeypatch.setattr(backends, "_analog_chunk",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.delenv(backends.ENV_VAR, raising=False)
    a, b = _pair(6, 40)
    cim.set_default_backend("analog-oracle")
    try:
        got = cim.sub(_t(a), _t(b), 6)
    finally:
        cim.set_default_backend(None)
    np.testing.assert_array_equal(got.numpy(), a - b)
    assert calls == [1]


# ---------------------------------------------------------------------------
# macros (tests/test_cim_macro.py, the analog-oracle cases)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("signed", [True, False])
def test_multiply_parity(signed):
    lo = -8 if signed else 0
    a, b = (RNG.randint(lo, lo + 16, 40).astype(np.int32) for _ in range(2))
    p = macro.multiply(PlanePack.pack(_t(a), 4, signed=signed),
                       PlanePack.pack(_t(b), 4, signed=signed), backend=BK)
    r = rmacro.multiply(RPack.pack(jnp.asarray(a), 4, signed=signed),
                        RPack.pack(jnp.asarray(b), 4, signed=signed),
                        backend=BK)
    assert p.n_bits == r.n_bits and p.signed == r.signed == signed
    np.testing.assert_array_equal(p.unpack().numpy(), a * b)
    _same_planes(p.planes, r.planes)
    assert LEDGER.accesses == RLEDGER.accesses == \
        planner.plan_multiply(4, 4, signed_b=signed).accesses


def test_abs_relu_min_max_parity():
    x = np.array([-128, -127, -1, 0, 1, 126, 127, -55], np.int32)
    y = np.array([127, -128, 0, -1, 1, -126, 127, 55], np.int32)
    px, py = PlanePack.pack(_t(x), 8), PlanePack.pack(_t(y), 8)
    for got, want in (
            (macro.abs_(px, backend=BK), np.abs(x)),
            (macro.relu(px, backend=BK), np.maximum(x, 0)),
            (macro.minimum(px, py, backend=BK), np.minimum(x, y)),
            (macro.maximum(px, py, backend=BK), np.maximum(x, y))):
        np.testing.assert_array_equal(got.unpack().numpy(), want)
    assert LEDGER.accesses == 4


@pytest.mark.parametrize("n_bits", [1, 3, 8])
def test_popcount_parity(n_bits):
    x = RNG.randint(-(2 ** (n_bits - 1)), 2 ** (n_bits - 1), 33) \
        .astype(np.int32)
    out = macro.popcount(PlanePack.pack(_t(x), n_bits), backend=BK)
    mask = (1 << n_bits) - 1
    want = np.array([bin(int(v) & mask).count("1") for v in x])
    np.testing.assert_array_equal(out.unpack().numpy(), want)
    assert LEDGER.accesses == planner.plan_popcount(n_bits).accesses


@pytest.mark.parametrize("n", [1, 2, 31])
def test_reduce_sum_parity(n):
    x = RNG.randint(-100, 100, n).astype(np.int32)
    out = macro.reduce_sum(PlanePack.pack(_t(x), 8), backend=BK)
    assert out.shape == ()
    assert int(out.unpack()) == int(x.sum())
    assert LEDGER.accesses == planner.plan_reduce_sum(n).accesses


def test_int8_matmul_matches_reference():
    """The acceptance case at the reference's analog size: exact int8 x int8
    -> int32, ledger equal to the plan and to the reference's run."""
    m, k, n = 3, 4, 2
    a = RNG.randint(-128, 128, (m, k)).astype(np.int32)
    b = RNG.randint(-128, 128, (k, n)).astype(np.int32)
    got = cim.matmul(_t(a), _t(b), n_bits=8, backend=BK)
    want = rcim.matmul(jnp.asarray(a), jnp.asarray(b), n_bits=8, backend=BK)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a @ b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert LEDGER.accesses == RLEDGER.accesses == \
        planner.plan_matmul(k, n, n_bits=8).accesses


# ---------------------------------------------------------------------------
# property cases (tests/test_cim_property.py:106,187), small widths
# ---------------------------------------------------------------------------


def _wrap32(v):
    return ((np.asarray(v, np.int64) + (1 << 31)) % (1 << 32)) - (1 << 31)


def _operands(n_bits, signed, seed, n_words=12):
    rng = np.random.RandomState(seed)
    if signed:
        lo, hi = -(1 << (n_bits - 1)), 1 << (n_bits - 1)
        edges = np.array([lo, -1, 0, 1, hi - 1], np.int64)
    else:
        lo, hi = 0, 1 << n_bits
        edges = np.array([0, 1, hi - 1, hi >> 1], np.int64)
    n_rand = max(0, n_words - len(edges))
    a = np.concatenate([edges, rng.randint(lo, hi, n_rand, dtype=np.int64)])
    b = np.concatenate([edges[::-1],
                        rng.randint(lo, hi, n_rand, dtype=np.int64)])
    return a, b


def _pack64(v, n_bits, signed):
    pattern = (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return PlanePack.pack(_t(pattern), n_bits, signed=signed)


@settings(**_PROP)
@given(st.integers(2, 8), st.booleans(), st.integers(0, 2**31 - 1))
def test_property_single_access_analog(n_bits, signed, seed):
    a, b = _operands(n_bits, signed, seed)
    mask = (1 << n_bits) - 1
    pa, pb = _pack64(a, n_bits, signed), _pack64(b, n_bits, signed)
    ops = ("add", "sub", "lt", "eq", "gt") + \
        (("carry_add", "carry_sub") if signed else ())
    out = cim.execute(pa, pb, ops, backend=BK)
    got = {op: out[op].unpack().numpy().astype(np.int64) for op in ops}
    np.testing.assert_array_equal(got["add"], _wrap32(a + b))
    np.testing.assert_array_equal(got["sub"], _wrap32(a - b))
    np.testing.assert_array_equal(got["lt"], (a < b).astype(np.int64))
    np.testing.assert_array_equal(got["eq"], (a == b).astype(np.int64))
    np.testing.assert_array_equal(got["gt"], (a > b).astype(np.int64))
    pat_a, pat_b = a & mask, b & mask
    if signed:
        np.testing.assert_array_equal(got["carry_add"],
                                      (pat_a + pat_b) >> n_bits)
        np.testing.assert_array_equal(
            got["carry_sub"], (pat_a + (~b & mask) + 1) >> n_bits)
    out = cim.execute(pa, pb, cim.BOOLEAN_OPS, backend=BK)
    ref = {
        "false": np.zeros_like(pat_a), "true": np.full_like(pat_a, mask),
        "and": pat_a & pat_b, "or": pat_a | pat_b, "xor": pat_a ^ pat_b,
        "nand": ~(pat_a & pat_b) & mask, "nor": ~(pat_a | pat_b) & mask,
        "xnor": ~(pat_a ^ pat_b) & mask, "a": pat_a, "b": pat_b,
        "not_a": ~pat_a & mask, "not_b": ~pat_b & mask,
        "a_and_not_b": pat_a & ~pat_b & mask,
        "not_a_and_b": ~pat_a & mask & pat_b,
        "a_or_not_b": (pat_a | (~pat_b & mask)) & mask,
        "not_a_or_b": ((~pat_a & mask) | pat_b) & mask,
    }
    for fn in cim.BOOLEAN_OPS:
        np.testing.assert_array_equal(
            out[fn].unpack().numpy().astype(np.int64), _wrap32(ref[fn]),
            err_msg=fn)


@settings(**_PROP)
@given(st.integers(2, 4), st.booleans(), st.integers(0, 2**31 - 1))
def test_property_macro_analog_oracle(n_bits, signed, seed):
    a, b = _operands(n_bits, signed, seed, n_words=6)
    pa, pb = _pack64(a, n_bits, signed), _pack64(b, n_bits, signed)
    p = macro.multiply(pa, pb, backend=BK)
    np.testing.assert_array_equal(p.unpack().numpy().astype(np.int64),
                                  _wrap32(a * b))
    if signed:
        np.testing.assert_array_equal(
            macro.relu(pa, backend=BK).unpack().numpy().astype(np.int64),
            _wrap32(np.maximum(a, 0)))


# ---------------------------------------------------------------------------
# the dispatcher and the lowering compiler
# ---------------------------------------------------------------------------


def test_tiling_round_trip_analog_oracle():
    """tests/test_cim_array.py:77: tiled on a small banked spec, equal to
    the untiled access and to the reference's tiled analog access, with the
    same per-bank ledger."""
    a, b = _pair(4, 40, np.random.RandomState(7))
    spec = dict(banks=2, subarrays=1, rows=64, bitline_words=32)
    ref = cim.execute(PlanePack.pack(_t(a), 4), PlanePack.pack(_t(b), 4),
                      ("sub", "lt"), backend=BK)
    LEDGER.reset()
    out = dispatch.execute_tiled(PlanePack.pack(_t(a), 4),
                                 PlanePack.pack(_t(b), 4), ("sub", "lt"),
                                 spec=ArraySpec(**spec), backend=BK)
    rout = rdisp.execute_tiled(RPack.pack(jnp.asarray(a), 4),
                               RPack.pack(jnp.asarray(b), 4), ("sub", "lt"),
                               spec=rcim.ArraySpec(**spec), backend=BK)
    for op in ("sub", "lt"):
        assert torch.equal(out[op].unpack(), ref[op].unpack())
        _same_planes(out[op].planes, rout[op].planes)
    assert LEDGER.accesses == RLEDGER.accesses == 2
    assert LEDGER.bank_accesses == RLEDGER.bank_accesses


def test_analog_oracle_backend_tiny_chain():
    """tests/test_cim_lower.py:318: one small fused chain through lower()."""
    def fn(a, b, c):
        return (a + b) - c

    a = torch.tensor([-8, -1, 0, 3], dtype=torch.int8)
    b = torch.tensor([7, 1, -2, 3], dtype=torch.int8)
    c = torch.tensor([1, -1, 5, -6], dtype=torch.int8)
    got = lower(fn, backend=BK)(a, b, c)
    assert torch.equal(got, fn(a, b, c))
    assert LEDGER.accesses == 2


@pytest.mark.parametrize("banked", [False, True])
def test_mlp_cim_analog_equals_fused(banked):
    """A lowered GeGLU MLP on the device model: output and ledger equal to
    the same call on the fused backend."""
    rng = np.random.RandomState(3)
    p = {k: _t(rng.normal(size=s).astype(np.float32)) for k, s in
         (("w_in", (16, 24)), ("w_gate", (16, 24)), ("w_out", (24, 16)))}
    x = _t(rng.normal(size=(2, 1, 16)).astype(np.float32))
    spec = ArraySpec(banks=2, subarrays=1, rows=256, bitline_words=64) \
        if banked else None
    runs = {}
    for bk in ("fused", BK):
        LEDGER.reset()
        out = tlayers.mlp_cim(p, x, "geglu", n_bits=8, backend=bk, spec=spec)
        runs[bk] = (out, LEDGER.accesses, LEDGER.load_accesses,
                    dict(LEDGER.bank_accesses))
    assert torch.equal(runs["fused"][0], runs[BK][0])
    assert runs["fused"][1:] == runs[BK][1:]
    assert runs[BK][1] > 0
