"""The port's kernels on the card, with torch, numpy and `repro_torch` alone.

The `cuda`-marked cases of `test_torch_adra_ops.py`, `test_torch_banked.py`,
`test_torch_flash.py`, `test_torch_fused_kernel.py`, `test_torch_rglru.py`
and `test_torch_slstm.py` import jax, and the card's machine has none; this
file repeats them without it. Each kernel is held to the port's plain
version (`repro_torch.kernels.ref` and the CPU path of each wrapper, which
the CPU tests hold to the reference), and the fused bit-plane kernel also to
the analog-oracle backend, the paper's FeFET device model evaluated per bit.
The autotuner measures on the card, and the tiled access, `cim.multiply`
and `lower()` over a one-rank NCCL mesh equal their unsharded calls (the
CPU tests hold the mesh path to the reference over 1, 2 and 4 gloo ranks).

Every case is marked `cuda` and skips without a card. `tests/conftest.py`
imports the reference, so on the card the file runs without it:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py

and resets the port's own ledger and resident sets itself.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.cim import backends as tbk  # noqa: E402
from repro_torch.cim import fused_kernel as tfk  # noqa: E402
from repro_torch.cim import opset  # noqa: E402
from repro_torch.cim.accounting import LEDGER  # noqa: E402
from repro_torch.cim.array import clear_resident  # noqa: E402
from repro_torch.core import sensing as tsense  # noqa: E402
from repro_torch.core.array import AdraArrayConfig, level_currents  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rglru as trglru  # noqa: E402
from repro_torch.kernels import slstm as tslstm  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card_state():
    """Skip without a card (decided here, never at import); reset the port's
    ledger and resident sets around each case; TF32 off for the float
    kernels' plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    LEDGER.reset()
    clear_resident()
    yield
    LEDGER.reset()
    clear_resident()
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _planes(seed, n_bits, w):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, (n_bits, w), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (n_bits, w), dtype=np.uint64).astype(np.uint32)
    return (torch.from_numpy(x.view(np.int32)).cuda() for x in (a, b))


# ---------------------------------------------------------------------------
# the fused bit-plane kernel (test_torch_fused_kernel.py, test_torch_banked.py)
# ---------------------------------------------------------------------------


def test_fused_kernel_matches_plain_version_and_device_model():
    """Every op at 2, 16 and 33 planes over a ragged width: the kernel
    equal to the bit to its plain version and to the analog-oracle backend
    on the card (both compute on the card: nothing moves to the CPU)."""
    analog = tbk.get_backend("analog-oracle")
    for n_bits in (2, 16, 33):
        a, b = _planes(n_bits, n_bits, 4099)
        got = tfk.fused_planes_op(a, b, opset.ALL_OPS)
        want = tfk.fused_planes_op_ref(a, b, opset.ALL_OPS)
        sensed = analog(a, b, opset.ALL_OPS)
        for g, r, s in zip(got, want, sensed):
            assert s.is_cuda
            assert torch.equal(g, r) and torch.equal(g, s)


def test_launch_counts_the_bytes_it_must_move():
    """Each launch adds (2 n_bits + output rows) x W x 4 bytes per tile."""
    a, b = _planes(9, 3 * 5, 33)
    a, b = a.view(3, 5, 33), b.view(3, 5, 33)
    before = tfk.fused_planes_op.bytes
    tfk.fused_planes_op(a, b, ("add", "lt", "xor"))
    assert tfk.fused_planes_op.bytes - before == \
        (2 * 5 + (5 + 1) + 1 + 5) * 33 * 4 * 3


def test_kernel_splits_long_tile_axes_and_counts_truthfully():
    t = tfk.MAX_TILES_PER_LAUNCH + 3
    gen = torch.Generator(device="cuda").manual_seed(0)
    a, b = (torch.randint(-2 ** 31, 2 ** 31, (t, 3, 8), dtype=torch.int32,
                          device="cuda", generator=gen) for _ in range(2))
    launches, moved = tfk.fused_planes_op.launches, tfk.fused_planes_op.bytes
    got = tfk.fused_planes_op(a, b, ("add", "lt"))
    assert tfk.fused_planes_op.launches - launches == 2
    assert tfk.fused_planes_op.bytes - moved == (2 * 3 + 4 + 1) * 8 * 4 * t
    for g, r in zip(got, tfk.fused_planes_op_ref(a, b, ("add", "lt"))):
        assert torch.equal(g, r)


def test_device_model_on_the_card_equals_the_cpu():
    """The level currents and margins computed on the card, within rtol
    1e-5 of the same computed on the CPU."""
    cfg = AdraArrayConfig()
    for fn in (lambda d: level_currents(cfg, True, device=d),
               lambda d: level_currents(cfg, False, device=d),
               lambda d: tsense.current_sense_margins(cfg, device=d),
               lambda d: tsense.voltage_sense_margins(cfg, device=d)):
        got = fn("cuda")
        assert got.is_cuda
        torch.testing.assert_close(got.cpu(), fn("cpu"), rtol=1e-5, atol=0)
    assert tsense.symmetric_sense_is_ambiguous(cfg, device="cuda")


# ---------------------------------------------------------------------------
# the ADRA op surface (test_torch_adra_ops.py)
# ---------------------------------------------------------------------------


def test_cuda_adra_sub_one_launch_against_baseline_two():
    rng = np.random.RandomState(0)
    a, b = (rng.randint(-2 ** 15, 2 ** 15, 1 << 16).astype(np.int32)
            for _ in range(2))
    ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    want = tref.adra_int_ref(ta, tb, 1, 16)
    n0 = tfk.fused_planes_op.launches
    got = tops.adra_sub(ta, tb, n_bits=16)
    n1 = tfk.fused_planes_op.launches
    base = tops.baseline_sub_then_cmp(ta, tb, n_bits=16)
    assert (n1 - n0, tfk.fused_planes_op.launches - n1) == (1, 2)
    for g, bs, w in zip(got, base, want):
        assert torch.equal(g, w) and torch.equal(bs, w)


def test_cuda_adra_sample_equals_plain_version():
    logits = torch.randn(2, 4099, generator=torch.Generator().manual_seed(1))
    got = tstep.adra_sample(logits.cuda())
    assert torch.equal(got.cpu(), tstep.adra_sample_ref(logits))


# ---------------------------------------------------------------------------
# flash attention (test_torch_flash.py)
# ---------------------------------------------------------------------------

#: the reference's kernel-vs-oracle tolerances (tests/test_kernels.py:113)
FLASH_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
FLASH_SHAPES = [(1, 128, 128, 4, 4, 64), (2, 128, 128, 4, 2, 64),
                (1, 256, 256, 8, 1, 64), (1, 64, 192, 4, 2, 32),
                (1, 300, 300, 8, 1, 256), (1, 90, 40, 4, 2, 64),
                (1, 70, 130, 4, 2, 96)]


def _qkv(shape, seed=0):
    b, tq, tk, hq, hkv, d = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, tq, hq, d)).astype(np.float32),
            rng.normal(size=(b, tk, hkv, d)).astype(np.float32),
            rng.normal(size=(b, tk, hkv, d)).astype(np.float32))


def test_flash_kernels_match_plain_version():
    """Both kernels against `mha_ref`, o and lse: the routed call (bf16 to
    the wgmma/TMA kernel, float32 to SIMT, by their launch counts) and the
    SIMT kernel in bf16; bf16 o also within a relative L2 distance of
    1e-2."""
    for shape in FLASH_SHAPES:
        for dtype in ("float32", "bfloat16"):
            tt = getattr(torch, dtype)
            q, k, v = (torch.from_numpy(a).cuda().to(tt) for a in _qkv(shape))
            kernels = [tflash.flash_attention]
            if dtype == "bfloat16":
                kernels.append(tflash.flash_attention_simt)
            for causal in (True, False):
                for fn in kernels:
                    before = (tflash.flash_attention_sm90.launches,
                              tflash.flash_attention_simt.launches)
                    o, lse = fn(q, k, v, causal=causal)
                    moved = (tflash.flash_attention_sm90.launches - before[0],
                             tflash.flash_attention_simt.launches - before[1])
                    sm90 = fn is tflash.flash_attention and \
                        dtype == "bfloat16"
                    assert moved == ((1, 0) if sm90 else (0, 1)), moved
                    op, lsep = tref.mha_ref(q, k, v, causal=causal)
                    tol = FLASH_TOL[dtype]
                    np.testing.assert_allclose(
                        o.float().cpu().numpy(), op.float().cpu().numpy(),
                        atol=tol, rtol=tol)
                    np.testing.assert_allclose(
                        lse.cpu().numpy(), lsep.cpu().numpy(), atol=1e-5,
                        rtol=1e-5)
                    if dtype == "bfloat16":
                        rel = (o.float() - op.float()).norm() / \
                            op.float().norm()
                        assert float(rel) <= 1e-2, (shape, causal, float(rel))


# ---------------------------------------------------------------------------
# RG-LRU (test_torch_rglru.py)
# ---------------------------------------------------------------------------


def _rglru_inputs(seed, b, t, d):
    rng = np.random.default_rng(seed)
    x, r, i = (rng.normal(size=(b, t, d)).astype(np.float32) for _ in range(3))
    ll = rng.normal(size=(d,)).astype(np.float32)
    h0 = rng.normal(size=(b, d)).astype(np.float32)
    return (torch.from_numpy(a).cuda() for a in (x, r, i, ll, h0))


def _rglru_close(y, h, yp, hp):
    torch.testing.assert_close(h, hp, atol=1e-5, rtol=0)
    dy = (y.float() - yp.float()).abs()
    assert bool((dy <= 2.0 ** -7 * yp.float().abs() + 1e-5).all())


def test_rglru_kernel_matches_plain_version():
    for (b, t, d), dtype in (((2, 1, 4096), torch.bfloat16),
                             ((3, 37, 1000), torch.float32)):
        x, r, i, ll, h0 = _rglru_inputs(3, b, t, d)
        x, r, i = (a.to(dtype) for a in (x, r, i))
        y, h = tops.rglru_scan(x, r, i, ll, h0=h0)
        _rglru_close(y, h, *tref.rglru_ref(x, r, i, ll, h0=h0))


def test_rglru_routed_kernels_match_plain_version():
    for (b, t, d), dtype in (((2, 1, 4096), torch.bfloat16),
                             ((1, 2040, 4096), torch.bfloat16),
                             ((2, 130, 1000), torch.float32)):
        x, r, i, ll, h0 = _rglru_inputs(5, b, t, d)
        x, r, i = (a.to(dtype) for a in (x, r, i))
        want = trglru.route(x, r, i)
        before = trglru.rglru_sm90.launches
        y, h = tops.rglru_scan(x, r, i, ll, h0=h0)
        assert trglru.rglru_sm90.launches - before == int(want == "sm90")
        _rglru_close(y, h, *tref.rglru_ref(x, r, i, ll, h0=h0))
        ya, ha = trglru.rglru_sm90(x, r, i, ll, h0=h0)
        yb, hb = trglru.rglru_rows(x, r, i, ll, h0=h0)
        assert torch.equal(ya, yb) and torch.equal(ha, hb)


# ---------------------------------------------------------------------------
# sLSTM (test_torch_slstm.py)
# ---------------------------------------------------------------------------


def _slstm_inputs(seed, b, t, d):
    """wx, R ~ N(0, 1/D) as the model draws it, b, and a random state."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    wx = rng.normal(size=(b, t, 4, d)).astype(f32)
    r = (rng.normal(size=(d, 4, d)) * d ** -0.5).astype(f32)
    bg = (rng.normal(size=(4, d)) * 0.1).astype(f32)
    h0, c0, m0 = (rng.normal(size=(b, d)).astype(f32) for _ in range(3))
    n0 = rng.uniform(0.5, 2.0, size=(b, d)).astype(f32)
    return [torch.from_numpy(a).cuda() for a in (wx, r, bg, h0, c0, n0, m0)]


def test_slstm_kernel_matches_plain_version():
    for (b, t, d), wx_dtype, r_dtype in (
            ((2, 1, 768), torch.float32, torch.bfloat16),
            ((3, 37, 1500), torch.float32, torch.float32),
            ((2, 48, 256), torch.bfloat16, torch.bfloat16)):
        args = _slstm_inputs(3, b, t, d)
        wx = args[0].to(wx_dtype)
        r, bg = args[1].to(r_dtype), args[2].to(r_dtype)
        y, state = tops.slstm_scan(wx, r, bg, *args[3:])
        yp, statep = tref.slstm_ref(wx, r, bg, *args[3:])
        for got, want in zip(state, statep):
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        dy = (y.float() - yp.float()).abs()
        assert bool((dy <= 2.0 ** -7 * yp.float().abs() + 1e-5).all())


def test_slstm_sm90_kernel_matches_plain_version():
    for b, t, d in ((2, 1, 768), (1, 512, 768), (4, 64, 768)):
        args = _slstm_inputs(4, b, t, d)
        r, bg = args[1].to(torch.bfloat16), args[2].to(torch.bfloat16)
        assert tslstm.route(args[0], r) == "sm90"
        before = tslstm.slstm_sm90.launches
        y, state = tops.slstm_scan(args[0], r, bg, *args[3:])
        assert tslstm.slstm_sm90.launches == before + 1
        yp, statep = tref.slstm_ref(args[0], r, bg, *args[3:])
        atol = 1e-5 if t <= 64 else 1e-4
        for got, want in zip([*state, y], [*statep, yp]):
            torch.testing.assert_close(got, want, atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# the recurrences' train path: kernel forward, plain-version backward
# ---------------------------------------------------------------------------


def _grads(fn, inputs, weights):
    """Every input's gradient of sum(w * out) over `fn`'s outputs."""
    ins = [a.detach().clone().requires_grad_(True) for a in inputs]
    outs = fn(*ins)
    sum(torch.sum(w * o.float()) for w, o in zip(weights, outs)).backward()
    return [a.grad for a in ins]


def test_recurrence_gradients_match_plain_version():
    """`ops.rglru_scan` and `ops.slstm_scan` under autograd on the card
    (one kernel launch per forward; the backward reruns the plain version)
    against the plain version's autograd on the CPU, float32."""
    x, r, i, ll, h0 = _rglru_inputs(6, 2, 64, 256)
    gen = torch.Generator().manual_seed(6)
    w = [torch.randn((2, 64, 256), generator=gen),
         torch.randn((2, 256), generator=gen)]
    before = trglru.launches()
    got = _grads(lambda *a: tops.rglru_scan(*a[:4], h0=a[4]),
                 (x, r, i, ll, h0), [a.cuda() for a in w])
    assert trglru.launches() == before + 1
    want = _grads(lambda *a: tref.rglru_ref(*a[:4], h0=a[4]),
                  [a.cpu() for a in (x, r, i, ll, h0)], w)
    for g, gw in zip(got, want):
        torch.testing.assert_close(g.cpu(), gw, atol=1e-5, rtol=1e-5)

    args = _slstm_inputs(7, 2, 48, 256)
    w = [torch.randn((2, 48, 256), generator=gen)] + [
        torch.randn((2, 256), generator=gen) for _ in range(4)]

    def flat(fn):
        def call(*a):
            y, state = fn(*a)
            return (y, *state)
        return call
    before = tslstm.launches()
    got = _grads(flat(tops.slstm_scan), args, [a.cuda() for a in w])
    assert tslstm.launches() == before + 1
    want = _grads(flat(tref.slstm_ref), [a.cpu() for a in args], w)
    for g, gw in zip(got, want):
        torch.testing.assert_close(g.cpu(), gw, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the autotuner and the mesh path (test_torch_autotune.py,
# test_torch_sharding.py)
# ---------------------------------------------------------------------------


def test_autotune_measures_on_the_card(tmp_path):
    """A measured search of a lowered function on the fused kernel: tuned
    no slower than the default, launches in the search, a warm call with
    no new search, the winners file round-tripped."""
    from repro_torch.cim.autotune import Autotuner, Candidate

    def fn(a, b):
        return (a + b) * b

    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randint(-100, 100, (1 << 16,), dtype=torch.int16,
                      device="cuda", generator=g)
    b = torch.randint(-100, 100, (1 << 16,), dtype=torch.int16,
                      device="cuda", generator=g)
    cands = (Candidate(banks=2, subarrays=2, bitline_words=1024),
             Candidate(banks=8, subarrays=4, bitline_words=256,
                       scheme="scheme2"))
    tuner = Autotuner()
    tfk.fused_planes_op.launches = 0
    res = tuner.tune(fn, (a, b), candidates=cands, steady_n=2)
    assert tfk.fused_planes_op.launches > 0
    assert res.tuned_ms <= res.default_ms
    assert res.tuned_vs_default_walltime_ratio >= 1.0
    assert tuner.tune(fn, (a, b), candidates=cands).from_cache
    assert tuner.searches == 1
    path = str(tmp_path / "winners.json")
    tuner.save(path)
    fresh = Autotuner()
    assert fresh.load(path) == 1
    assert fresh.tune(fn, (a, b), candidates=cands).winner == res.winner
    assert fresh.searches == 0


def test_mesh_path_on_a_one_rank_nccl_group():
    """`execute_sharded`, `cim.multiply(mesh=)` and `lower(mesh=)` on a
    (1,) "data" mesh of one NCCL rank: planes, outputs and ledgers equal
    to the unsharded calls, one launch a logical access."""
    import dataclasses
    import socket

    import torch.distributed as dist

    from repro_torch import cim
    from repro_torch.cim import PlanePack, dispatch
    from repro_torch.cim.lower import lower
    from repro_torch.launch.mesh import make_mesh

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("data",), "cuda")
        spec = cim.ArraySpec(banks=2, subarrays=1, rows=256,
                             bitline_words=32)
        a, b = _planes(5, 29, 4099)
        pa = PlanePack(a, 29, True, (4099 * 32,))
        pb = PlanePack(b, 29, True, (4099 * 32,))
        x = torch.arange(-700, 700, dtype=torch.int16, device="cuda")
        y = (x * 7 + 3) % 101
        got = []
        for m in (None, mesh):
            LEDGER.reset()
            tfk.fused_planes_op.launches = 0
            o = dispatch.execute_tiled(pa, pb, ("add", "lt"), spec=spec,
                                       mesh=m)
            prod = cim.multiply(PlanePack.pack(x, 16), PlanePack.pack(y, 16),
                                spec=spec, mesh=m)
            low = lower(lambda u, v: (u + v) * v, spec=spec, mesh=m)(x, y)
            torch.cuda.synchronize()
            got.append((o["add"].planes, o["lt"].planes, prod.unpack(), low,
                        dataclasses.asdict(LEDGER),
                        tfk.fused_planes_op.launches))
        (a0, l0, p0, w0, led0, n0), (a1, l1, p1, w1, led1, n1) = got
        assert torch.equal(a0, a1) and torch.equal(l0, l1)
        assert torch.equal(p0, p1) and torch.equal(w0, w1)
        assert torch.equal(p1.to(torch.int64),
                           x.to(torch.int64) * y.to(torch.int64))
        assert led0 == led1 and n0 == n1
    finally:
        dist.destroy_process_group()
