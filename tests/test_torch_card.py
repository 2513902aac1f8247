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

The float paths' step programs (the donated decode, the donated train
step, the float serve) and the mesh programs (over a one-rank NCCL group:
the tiled access, the schedule programs, the sharded train step) replay
as CUDA graphs equal to their eager runs.

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


def _one_rank_nccl():
    """A one-rank NCCL process group (its communicator made at once)."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))


def test_mesh_path_on_a_one_rank_nccl_group():
    """`execute_sharded`, `cim.multiply(mesh=)` and `lower(mesh=)` on a
    (1,) "data" mesh of one NCCL rank, 3 calls each (the eager first call,
    the capture as a CUDA graph with its all-gathers, a replay): planes,
    outputs and ledgers of every call equal to the unsharded calls, one
    launch a logical access, every program over the mesh captured once."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import cim
    from repro_torch.cim import PlanePack, dispatch
    from repro_torch.cim.lower import lower
    from repro_torch.launch.mesh import make_mesh

    _one_rank_nccl()
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
        dispatch.clear_schedule_cache()
        plain, meshed = (lower(lambda u, v: (u + v) * v, spec=spec, mesh=m)
                         for m in (None, mesh))
        for m, lowered in [(None, plain)] + [(mesh, meshed)] * 3:
            LEDGER.reset()
            tfk.fused_planes_op.launches = 0
            o = dispatch.execute_tiled(pa, pb, ("add", "lt"), spec=spec,
                                       mesh=m)
            prod = cim.multiply(PlanePack.pack(x, 16), PlanePack.pack(y, 16),
                                spec=spec, mesh=m)
            low = lowered(x, y)
            torch.cuda.synchronize()
            got.append((o["add"].planes, o["lt"].planes, prod.unpack(), low,
                        dataclasses.asdict(LEDGER),
                        tfk.fused_planes_op.launches))
        (a0, l0, p0, w0, led0, n0) = got[0]
        assert torch.equal(p0.to(torch.int64),
                           x.to(torch.int64) * y.to(torch.int64))
        for a1, l1, p1, w1, led1, n1 in got[1:]:
            assert torch.equal(a0, a1) and torch.equal(l0, l1)
            assert torch.equal(p0, p1) and torch.equal(w0, w1)
            assert led0 == led1 and n0 == n1
        on_mesh = [p.stats for k, p in dispatch._PROGRAMS.items()
                   if k[-1] is not None]
        assert on_mesh and all(s["captured"] == 1 and s["replays"] >= 1
                               for s in on_mesh), on_mesh
    finally:
        dispatch.clear_schedule_cache()
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# whole-schedule CUDA graphs (test_torch_graphs.py holds the bookkeeping
# against a stand-in graph on the CPU)
# ---------------------------------------------------------------------------


def _graph_calls():
    """Each case: a call through one or more cached programs, its result as
    a flat tuple of tensors."""
    from repro_torch import cim
    from repro_torch.cim import PlanePack, dispatch, macro
    from repro_torch.models import attention as tattn
    from repro_torch.models import layers as tlayers

    g = torch.Generator(device="cuda").manual_seed(3)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, device="cuda", generator=g,
                             dtype=torch.int32)

    x, y = ints(-30000, 30000, (1 << 20,)), ints(-30000, 30000, (1 << 20,))
    a, b = ints(-128, 128, (64, 2048)), ints(-128, 128, (2048, 256))
    ba, bb = ints(-128, 128, (2, 4, 256)), ints(-128, 128, (2, 256, 16))
    pa_, pb_ = _planes(5, 29, 4099)
    pa = PlanePack(pa_, 29, True, (4099 * 32,))
    pb = PlanePack(pb_, 29, True, (4099 * 32,))
    spec = cim.ArraySpec(banks=2, subarrays=1, rows=256, bitline_words=32)
    w = {k: torch.randn(shape, device="cuda", generator=g) * 0.05
         for k, shape in (("w_in", (256, 1024)), ("w_gate", (256, 1024)),
                          ("w_out", (1024, 256)))}
    h = torch.randn((2, 1, 256), device="cuda", generator=g)
    q = torch.randn((2, 1, 4, 64), device="cuda", generator=g)
    k, v = (torch.randn((2, 16, 2, 64), device="cuda", generator=g)
            for _ in range(2))
    mask = (torch.arange(16, device="cuda")[None, :]
            <= torch.tensor([[9], [15]], device="cuda"))[:, None, :]
    return {
        "multiply": lambda: (cim.multiply(PlanePack.pack(x, 16),
                                          PlanePack.pack(y, 16)).planes,),
        "matmul": lambda: (cim.matmul(a, b),),
        "batched_matmul": lambda: (macro.batched_matmul(ba, bb),),
        "banked_access": lambda: tuple(
            o.planes for o in dispatch.execute_tiled(
                pa, pb, ("add", "lt"), spec=spec).values()),
        "resident_mlp": lambda: (tlayers.mlp_cim(w, h, "geglu",
                                                 resident=True),),
        "sdpa_cim": lambda: (tattn.sdpa_cim(q, k, v, mask, 0.125),),
    }


@pytest.mark.parametrize("case", ["multiply", "matmul", "batched_matmul",
                                  "banked_access", "resident_mlp",
                                  "sdpa_cim"])
def test_graph_replay_equals_the_eager_body(case):
    """Three calls (eager, captured, replayed) against the eager body's
    warm call inside `eager_programs`: results to the bit, the whole ledger,
    and the launch, byte and dispatch counts equal."""
    import dataclasses

    from repro_torch.cim import dispatch

    call = _graph_calls()[case]

    def once():
        LEDGER.reset()
        fp = tfk.fused_planes_op
        c0 = (fp.launches, fp.bytes, dispatch.cache_stats()["dispatches"])
        out = call()
        torch.cuda.synchronize()
        c1 = (fp.launches, fp.bytes, dispatch.cache_stats()["dispatches"])
        return out, dataclasses.asdict(LEDGER), \
            tuple(b - a for a, b in zip(c0, c1))

    dispatch.clear_schedule_cache()
    with dispatch.eager_programs():
        once()                                # pins, for the resident MLP
        want, want_led, want_counts = once()
    assert want_counts[0] > 0 and want_counts[2] > 0
    dispatch.clear_schedule_cache()
    for i in range(3):
        got, led, counts = once()
        assert all(torch.equal(o, r) for o, r in zip(got, want)), (case, i)
        assert led == want_led and counts == want_counts, (case, i)
    stats = dispatch.graph_stats()
    assert stats["captured"] >= 1 and stats["replays"] >= 2, stats
    dispatch.clear_schedule_cache()


@pytest.mark.parametrize("k,n", [(12800, 4096), (4096, 12800)])
def test_broadcast_lhs_pack_equals_expanded_at_the_cell_widths(k, n):
    """granite-3-8b's decode MLP lhs packs over 2 slots (down: [2, 12800]
    to K_pad 16384, N 4096; up and gate: [2, 4096], N 12800): the planes
    written straight from the lhs equal the expanded layout's pack to the
    bit."""
    from repro_torch.cim import macro as tmacro
    from repro_torch.cim import planner as tplan
    from repro_torch.cim.planepack import PlanePack

    gen = torch.Generator(device="cuda").manual_seed(k)
    a = torch.randint(-128, 128, (2, k), device="cuda", generator=gen,
                      dtype=torch.int32)
    a[0, 0], a[-1, -1] = -128, 127
    k_pad = 1 << tplan._log2_ceil(k)
    want = PlanePack.pack(tmacro._expand_lhs(a, k_pad, n), 8, signed=True)
    got = tmacro._lhs_pack(a, k_pad, n, 8, True)
    assert got.planes.is_cuda and torch.equal(got.planes, want.planes)
    assert (got.n_bits, got.signed, got.shape) == \
        (want.n_bits, want.signed, want.shape)


def test_broadcast_matmul_counts_every_replay():
    """The down product of the cell (a [2, 12800] lhs on a resident
    [12800, 4096] rhs) through its program: eager, captured, then replayed
    twice, each call exact and counted once as a broadcast lhs pack."""
    from repro_torch.cim import dispatch
    from repro_torch.cim import macro as tmacro

    gen = torch.Generator(device="cuda").manual_seed(3)
    a = torch.randint(-128, 128, (2, 12800), device="cuda", generator=gen,
                      dtype=torch.int32)
    b = torch.randint(-128, 128, (12800, 4096), device="cuda", generator=gen,
                      dtype=torch.int32)
    want = (a.double() @ b.double()).to(torch.int64)
    bp = tmacro.matmul_rhs_pack(b, 2, 8)
    dispatch.clear_schedule_cache()
    for i in range(4):
        c0 = tmacro.lhs_pack_counts()
        got = tmacro.matmul(a, b_pack=bp)
        torch.cuda.synchronize()
        c1 = tmacro.lhs_pack_counts()
        assert torch.equal(got.to(torch.int64), want), i
        assert (c1["broadcast"] - c0["broadcast"],
                c1["expanded"] - c0["expanded"]) == (1, 0), i
    stats = dispatch.graph_stats()
    assert (stats["captured"], stats["replays"]) == (1, 3), stats
    dispatch.clear_schedule_cache()


def _item_body(cur, a, b):
    out = cur.execute(a, b, ("add",))["add"]
    int(out.planes.sum())                 # a host read of a device value
    return out


def test_a_body_that_cannot_be_captured_raises():
    """`.item()` in a body runs at its first (eager) call, then the capture
    of its second refuses it by name, and so does every later call: no
    eager fallback. Inside `eager_programs` it runs."""
    from repro_torch.cim import PlanePack, dispatch, macro, planner
    from repro_torch.cim.opset import CimOpError

    a_, b_ = _planes(2, 8, 64)
    pa, pb = PlanePack(a_, 8, True, (2048,)), PlanePack(b_, 8, True, (2048,))
    sched = planner.plan_elementwise(("add",), 9)
    dispatch.clear_schedule_cache()
    macro.run_schedule_program(sched, _item_body, (pa, pb), body_key=("i",))
    for _ in range(2):
        with pytest.raises(CimOpError, match="_local_scalar_dense"):
            macro.run_schedule_program(sched, _item_body, (pa, pb),
                                       body_key=("i",))
    with dispatch.eager_programs():
        macro.run_schedule_program(sched, _item_body, (pa, pb),
                                   body_key=("i",))
    dispatch.clear_schedule_cache()


# ---------------------------------------------------------------------------
# the float paths' step programs as CUDA graphs
# ---------------------------------------------------------------------------


def _reduced_model(arch: str, seed: int = 0):
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    return Model(get_config(arch).reduced(), device="cuda", seed=seed)


def _launch_counts():
    from repro_torch.cim import dispatch

    return dispatch._counters()


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-9b",
                                  "xlstm-125m", "deepseek-v2-lite-16b"])
def test_donated_decode_graph_equals_eager(arch):
    """Prefill 9 positions, then 4 decode steps through the donated decode
    program (eager, captured, replayed twice; xlstm-125m's sLSTM decode is
    the cooperative grid's launch, captured): logits and caches equal to
    the eager `decode_step`'s to the bit, the caller's cache tensors
    updated in place, every kernel counter moved as eager's."""
    from repro_torch import tree
    from repro_torch.cim import dispatch
    from repro_torch.train import make_decode_step

    model = _reduced_model(arch)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, model.cfg.vocab_size, (2, 13))).cuda()
    caches, _ = model.prefill({"tokens": toks[:, :9]}, max_len=13)
    eager = [{k: v.clone() for k, v in c.items()} for c in caches]
    held = tree.leaves(caches)
    prog = dispatch.Program(make_decode_step(model), donate=(0,))
    dispatch.clear_schedule_cache()
    for t in range(9, 13):
        inp = {"tokens": toks[:, t:t + 1],
               "positions": torch.full((2,), t, dtype=torch.int32,
                                       device="cuda")}
        c0 = _launch_counts()
        _, logits = prog(caches, inp)
        c1 = _launch_counts()
        eager, want = model.decode_step(eager, inp)
        c2 = _launch_counts()
        torch.cuda.synchronize()
        assert torch.equal(logits, want), (arch, t)
        assert all(a is b for a, b in zip(tree.leaves(caches), held))
        assert all(torch.equal(a, b) for a, b in
                   zip(tree.leaves(caches), tree.leaves(eager))), (arch, t)
        assert tuple(b - a for a, b in zip(c0, c1)) == \
            tuple(b - a for a, b in zip(c1, c2)), (arch, t)
    assert (prog.stats["eager"], prog.stats["captured"],
            prog.stats["replays"]) == (1, 1, 3)
    dispatch.clear_schedule_cache()


@pytest.mark.parametrize("arch", ["gemma-2b", "recurrentgemma-9b",
                                  "xlstm-125m"])
def test_train_step_graph_equals_eager(arch):
    """3 train steps of 2 x 64 through the donated step program (eager,
    captured, replayed) and 3 eager steps from the same weights under a
    cosine schedule that moves the learning rate: losses, grad norms and
    learning rates equal to the bit, every kernel counter as eager's."""
    from repro_torch.cim import dispatch
    from repro_torch.optim import AdamWConfig, cosine_schedule
    from repro_torch.train import init_state, make_train_step

    opt = AdamWConfig(lr=1e-3)
    runs = []
    for graphed in (True, False):
        model = _reduced_model(arch, seed=1)
        state = init_state(model, opt)
        step = make_train_step(model, opt,
                               lr_schedule=cosine_schedule(1e-3, 5, 10))
        prog = dispatch.Program(step, donate=(0,))
        rng = np.random.default_rng(9)
        out = []
        dispatch.clear_schedule_cache()
        for s in range(3):
            batch = {k: torch.from_numpy(rng.integers(
                0, model.cfg.vocab_size, (2, 64))).cuda()
                for k in ("tokens", "targets")}
            c0 = _launch_counts()
            if graphed:
                _, m = prog(state, batch)
            else:
                with dispatch.eager_programs():
                    _, m = prog(state, batch)
            torch.cuda.synchronize()
            out.append(([float(m[k]) for k in ("loss", "grad_norm", "lr")],
                        tuple(b - a for a, b in zip(c0, _launch_counts()))))
        assert prog.stats["captured"] == (1 if graphed else 0)
        runs.append(out)
        dispatch.clear_schedule_cache()
    assert runs[0] == runs[1], runs


def test_mesh_train_step_graph_equals_eager():
    """4 train steps of reduced llama3.2-1b on a (1, 1) mesh of one NCCL
    rank, DTensor state and batch, through the donated step program
    (eager, captured with its collectives, replayed), and 4 steps under
    `eager_programs()` from the same weights: losses, grad norms and
    learning rates equal to the bit, every kernel counter as eager's."""
    import torch.distributed as dist

    from repro_torch.cim import dispatch
    from repro_torch.data import DataConfig, sharded_batch, synthetic_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import AdamWConfig, cosine_schedule
    from repro_torch.sharding import batch_specs, distribute_model, to_named
    from repro_torch.train import init_state, make_train_step

    opt = AdamWConfig(lr=1e-3)
    runs = []
    _one_rank_nccl()
    try:
        for graphed in (True, False):
            mesh = make_mesh((1, 1), ("data", "model"), "cuda")
            model = _reduced_model("llama3.2-1b", seed=1)
            distribute_model(model, model.cfg, mesh)
            state = init_state(model, opt)
            step = make_train_step(model, opt,
                                   lr_schedule=cosine_schedule(1e-3, 5, 10))
            prog = dispatch.Program(step, donate=(0,), mesh=mesh)
            dcfg = DataConfig(vocab_size=model.cfg.vocab_size, batch=2,
                              seq_len=64)
            out = []
            dispatch.clear_schedule_cache()
            for s in range(4):
                host = synthetic_batch(s, dcfg)
                batch = sharded_batch(s, dcfg, mesh, to_named(
                    mesh, batch_specs(model.cfg, host, mesh)))
                c0 = _launch_counts()
                if graphed:
                    _, m = prog(state, batch)
                else:
                    with dispatch.eager_programs():
                        _, m = prog(state, batch)
                torch.cuda.synchronize()
                out.append(([float(m[k]) for k in ("loss", "grad_norm",
                                                   "lr")],
                            tuple(b - a for a, b in
                                  zip(c0, _launch_counts()))))
            assert prog.stats["captured"] == (1 if graphed else 0)
            runs.append(out)
            dispatch.clear_schedule_cache()
    finally:
        dist.destroy_process_group()
    assert runs[0] == runs[1], runs


def test_float_serve_graphs_equal_eager():
    """The reduced hybrid's float serve (3 requests on 2 slots): prefill,
    decode and insert replayed from CUDA graphs give the tokens the same
    run under `eager_programs` gives."""
    from repro_torch.cim import dispatch
    from repro_torch.launch import serve

    model = _reduced_model("recurrentgemma-9b", seed=2)
    reqs = [serve.ServeRequest(rid=i, prompt_len=6, gen=5)
            for i in range(3)]
    rep = serve.ServeEngine(model, slots=2, max_len=11).run(reqs)
    with dispatch.eager_programs():
        eager = serve.ServeEngine(model, slots=2, max_len=11).run(
            [serve.ServeRequest(rid=i, prompt_len=6, gen=5)
             for i in range(3)])
    assert [r["token_ids"] for r in rep["per_request"]] == \
        [r["token_ids"] for r in eager["per_request"]]
    for name in ("prefill", "decode", "insert"):
        assert rep["step_graphs"][name]["replays"] > 0, name
    assert rep["capture_steps"] and eager["capture_steps"] == []
