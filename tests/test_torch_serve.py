"""Port vs reference: the int8 CiM serve slice on reduced gemma-2b.

Weights come from the reference's init through `params_from_jax`, so both
packages compute the same function. Where the reference runs through its
lowering compiler, the `jax.core.Literal`/`Var` aliases it needs under
JAX 0.9 are applied inside the test only (monkeypatch), and its lowered
caches are dropped afterwards.
"""
import argparse
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
from repro.configs.base import ArchConfig as RArch
from repro.configs.registry import GEMMA_2B as R_GEMMA
from repro.configs.registry import RECURRENTGEMMA_9B as R_RG
from repro.launch.paged_kv import PagedKV as RPaged
from repro.models import attention as rattn
from repro.models import build as rbuild
from repro.models import layers as rlayers
from repro_torch import resolve_device
from repro_torch.cim import array as tarray
from repro_torch.cim import dispatch as tdisp
from repro_torch.cim.accounting import LEDGER as TLEDGER
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.configs.registry import GEMMA_2B as T_GEMMA
from repro_torch.configs.registry import RECURRENTGEMMA_9B as T_RG
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch.paged_kv import PagedKV as TPaged
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Model, with_cim

#: float tolerance against the reference's host twins: both contract the
#: same integers exactly; what differs is float32 rounding in the quantize
#: / rescale / GELU / softmax ops of two frameworks
F32_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _fresh_state():
    for clear in (TLEDGER.reset, tarray.clear_resident,
                  tdisp.clear_schedule_cache, rdisp.clear_schedule_cache):
        clear()
    yield
    for clear in (TLEDGER.reset, tarray.clear_resident,
                  tdisp.clear_schedule_cache, rdisp.clear_schedule_cache):
        clear()


@pytest.fixture
def ref_lowering(monkeypatch):
    """The reference's lowering under JAX 0.9, for this test only."""
    monkeypatch.setattr(jax.core, "Literal", jex.Literal, raising=False)
    monkeypatch.setattr(jax.core, "Var", jex.Var, raising=False)
    yield
    rlayers._LOWERED_MLP.clear()
    rlayers._LOWERED_LINEAR.clear()
    rattn._LOWERED_SDPA.clear()


def _np_params(model, seed):
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))


def _reduced(arch_cls, base):
    return dataclasses.replace(base.reduced(), cim_mlp_bits=8,
                               cim_attention_bits=8, cim_unroll_groups=True)


def test_mlp_cim_matches_host_twins():
    rng = np.random.default_rng(0)
    rcfg = _reduced(RArch, R_GEMMA)
    rp = jax.tree.map(np.asarray, rlayers.mlp_init(
        jax.random.PRNGKey(1), rcfg.d_model, rcfg.d_ff, rcfg.gating,
        jnp.float32))
    tp = {k: torch.from_numpy(v.copy()) for k, v in rp.items()}
    x = rng.normal(size=(2, 3, rcfg.d_model)).astype(np.float32)
    tx = torch.from_numpy(x)
    cim = tlayers.mlp_cim(tp, tx, "geglu")
    twin = tlayers._mlp_quantized(tp, tx, "geglu", 8)
    assert torch.equal(cim, twin)
    ref = np.asarray(rlayers._mlp_quantized(
        {k: jnp.asarray(v) for k, v in rp.items()}, jnp.asarray(x), "geglu", 8))
    np.testing.assert_allclose(cim.numpy(), ref, **F32_TOL)
    # three contractions, one dispatch each: gate/up (K=64), down (K=128)
    assert tdisp.cache_stats()["dispatches"] == 3
    assert TLEDGER.accesses == 21 + 21 + 22


def test_sdpa_cim_matches_host_twins():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    valid = np.arange(9)[None, :] <= np.array([5, 8])[:, None]
    mask = valid[:, None, :]
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    cim = tattn.sdpa_cim(tq, tk, tv, torch.from_numpy(mask), 0.25)
    twin = tattn._sdpa_quantized(tq, tk, tv, torch.from_numpy(mask), 0.25)
    assert torch.equal(cim, twin)
    ref = np.asarray(rattn._sdpa_quantized(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        0.25))
    np.testing.assert_allclose(cim.numpy(), ref, **F32_TOL)
    assert tdisp.cache_stats()["dispatches"] == 2


def _bench_cfgs(resident):
    kw = dict(name="bench-decode", family="dense", n_layers=2, d_model=16,
              n_heads=4, n_kv_heads=2, head_dim=8, d_ff=32, vocab_size=64,
              dtype="float32", tensor_parallel=False, cim_mlp_bits=8,
              cim_attention_bits=8, cim_unroll_groups=True,
              cim_resident=resident)
    return RArch(**kw), TArch(**kw)


@pytest.mark.parametrize("resident", [False, True])
def test_decode_step_counts_match_reference(ref_lowering, resident):
    """The kernel bench's decode step: 188 accesses, 10 dispatches (3 MLP
    regions + 2 attention regions per layer), and the same loads."""
    rcfg, tcfg = _bench_cfgs(resident)
    rmodel = rbuild(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(2))
    tmodel = Model(tcfg, params=params_from_jax(
        jax.tree.map(np.asarray, rparams), tcfg, device="cpu"))
    rcaches = rmodel.init_caches(2, 8)
    tcaches = tmodel.init_caches(2, 8)
    rstep = {"tokens": jnp.array([[1], [2]], jnp.int32),
             "positions": jnp.array([3, 5], jnp.int32)}
    tstep = {"tokens": torch.tensor([[1], [2]]),
             "positions": torch.tensor([3, 5], dtype=torch.int32)}
    rarray.clear_resident()
    for step in range(2):                      # cold (pins), then warm
        RLEDGER.reset()
        TLEDGER.reset()
        r0, t0 = rdisp.cache_stats(), tdisp.cache_stats()
        _, rlog = rmodel.decode_step(rparams, rcaches, rstep)
        _, tlog = tmodel.decode_step(tcaches, tstep)
        r1, t1 = rdisp.cache_stats(), tdisp.cache_stats()
        assert TLEDGER.accesses == RLEDGER.accesses == 188
        for c in ("dispatches", "misses", "hits", "resident_pins",
                  "resident_hits"):
            assert t1[c] - t0[c] == r1[c] - r0[c], (step, c)
        assert t1["dispatches"] - t0["dispatches"] == 10
        for f in ("load_accesses", "load_words32", "resident_reuses",
                  "words32", "per_op"):
            assert getattr(TLEDGER, f) == getattr(RLEDGER, f), (step, f)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), **F32_TOL)


def test_serve_engine_tokens_match_reference(ref_lowering):
    """Same greedy tokens as the reference engine: reduced gemma-2b with
    the int8 CiM decode, 2 slots x 2 requests, the reference's prompts."""
    from repro.launch import serve as rserve
    from repro.train import make_prefill_step

    rcfg = _reduced(RArch, R_GEMMA)
    tcfg = with_cim(T_GEMMA.reduced(), 8)
    rmodel = rbuild(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    rserve._fresh_cim_state()
    eng = rserve.ServeEngine(rmodel, rparams, slots=2, max_len=7,
                             cim_lower=True, warmup_steps=1)
    # the reference's prefill unjitted: the same function, without a
    # whole-model XLA compile per engine (the port's prefill is eager too)
    eng.prefill_fn = make_prefill_step(rmodel, 7)
    rrep = eng.run([rserve.ServeRequest(rid=i, prompt_len=4, gen=3)
                    for i in range(2)])
    prompts = [np.asarray(eng._prompt_inputs(rserve.ServeRequest(
        rid=i, prompt_len=4, gen=3))["tokens"])[0].tolist() for i in range(2)]
    tmodel = Model(tcfg, params=params_from_jax(
        jax.tree.map(np.asarray, rparams), tcfg, device="cpu"))
    args = tserve.parse_args(["--preset", "reduced", "--device", "cpu",
                              "--slots", "2", "--requests", "2",
                              "--prompt-len", "4", "--gen", "3",
                              "--cim-lower"])
    tserve.fresh_cim_state()
    reqs = [tserve.ServeRequest(rid=i, prompt_len=4, gen=3, prompt=prompts[i])
            for i in range(2)]
    trep = tserve.serve_once(tmodel, args, requests=reqs)
    assert [r["token_ids"] for r in trep["per_request"]] == \
        [r["token_ids"] for r in rrep["per_request"]]
    # per decode step: 2 layers x (21 + 21 + 22 MLP + 19 QK^T + 18 AV)
    assert set(trep["step_accesses"]) == {202}
    assert set(trep["step_dispatches"]) == {10}
    assert trep["decode_steps"] == rrep["decode_steps"]


def test_serve_main_phases_on_cpu():
    """repack -> resident -> warm replay: equal compute accesses/token,
    strictly fewer total accesses/token, zero new programs and pins."""
    out = tserve.main(["--preset", "reduced", "--device", "cpu", "--slots",
                       "2", "--requests", "2", "--prompt-len", "4", "--gen",
                       "3", "--cim-lower", "--cim-resident", "--assert-warm"])
    ph = out["phases"]
    assert ph["resident"]["accesses_per_token"] == \
        ph["repack"]["accesses_per_token"]
    assert ph["resident"]["total_accesses_per_token"] < \
        ph["repack"]["total_accesses_per_token"]
    assert out["warm_replay"]["program_cache_miss_delta"] == 0
    assert out["warm_replay"]["resident_pin_delta"] == 0
    toks = [[r["token_ids"] for r in p["per_request"]] for p in ph.values()]
    assert toks[0] == toks[1] == toks[2]


def test_host_twin_model_gives_the_cim_tokens():
    cfg = with_cim(T_GEMMA.reduced(), 8)
    model = Model(cfg, device="cpu", seed=3)
    args = tserve.parse_args(["--preset", "reduced", "--device", "cpu",
                              "--slots", "2", "--requests", "3",
                              "--prompt-len", "5", "--gen", "3",
                              "--cim-lower"])
    cim = tserve.serve_once(model, args)
    twin = tserve.serve_once(
        model.derive(dataclasses.replace(cfg, cim_host_twin=True)), args)
    assert [r["token_ids"] for r in cim["per_request"]] == \
        [r["token_ids"] for r in twin["per_request"]]


def test_full_width_residency_bookkeeping():
    """gemma-2b at full width, 2 slots, prompt 8 + gen 8, on the CPU (no
    model): with the paper's 1024-word bitlines a decode weight pin needs
    more rows per bank than the resident budget, so the reference's
    residency planning would leave every MLP weight streamed; with the serve
    path's array (2^24-word bitlines) all 54 pins and the KV blocks fit one
    set and stay pinned."""
    m, k, n = 2, 2048, 16384
    wide = tserve.resident_array_spec(with_cim(T_GEMMA, 8), m, 16)
    assert wide == tarray.ArraySpec(bitline_words=1 << 24)   # rows unchanged
    assert wide.tile_words == m * k * n
    for mod_array, mod_paged, cfg in ((rarray, RPaged, R_GEMMA),
                                      (tarray, TPaged, T_GEMMA)):
        default = mod_array.ResidentSet(mod_array.DEFAULT_SPEC,
                                        reserve_rows=256)
        rows = default._rows_for(8, m * k * n)
        assert max(rows.values()) == 32768 > 1024 - 256
        paged = mod_paged.for_model(cfg, spec=mod_array.DEFAULT_SPEC, slots=2,
                                    max_len=16, resident_set=default)
        assert paged.block_tokens == 1 and paged.n_blocks == 32

        spec = mod_array.ArraySpec(bitline_words=wide.bitline_words)
        rs = mod_array.ResidentSet(spec, reserve_rows=spec.rows // 4)
        paged = mod_paged.for_model(cfg, spec=spec, slots=2, max_len=16,
                                    resident_set=rs)
        assert paged.alloc(0, 8) and paged.alloc(1, 8)
        for layer in range(18):
            for j, (kk, nn) in enumerate(((k, n), (k, n), (n, k))):
                pack = argparse.Namespace(n_bits=8, n_words=m * kk * nn)
                rs.pin(("w", layer, j), pack)
        assert rs.evictions == 0 and len(rs) == 54 + 2
        assert rs.rows_per_bank() == {0: 54 * 8 + 16, 1: 16}
    TLEDGER.reset()
    RLEDGER.reset()


def test_full_width_residency_bookkeeping_hybrid():
    """recurrentgemma-9b at full width, 2 slots, prompt 8 + gen 6: the
    widened bitlines (2^25 words) make each of the 114 decode weight pins
    (38 layers x gate, up, down) one tile, and one-tile pins all land on
    bank 0. With the paper's 1024 rows the LRU would evict pins before
    their reuse; `resident_array_spec` doubles the rows until bank 0 holds
    every pin and its KV block, checked with both packages' own
    ResidentSet and PagedKV."""
    m, d, f = 2, 4096, 12288
    spec_t = tserve.resident_array_spec(with_cim(T_RG, 8), m, 14)
    assert (spec_t.banks, spec_t.subarrays) == (4, 4)
    assert spec_t.bitline_words == 1 << 25 and spec_t.rows == 2048
    pins = [m * d * f, m * d * f, m * 16384 * d] * 38
    for mod_array, mod_paged, cfg in ((rarray, RPaged, R_RG),
                                      (tarray, TPaged, T_RG)):
        for rows, fits in ((1024, False), (spec_t.rows, True)):
            spec = mod_array.ArraySpec(bitline_words=spec_t.bitline_words,
                                       rows=rows)
            rs = mod_array.ResidentSet(spec, reserve_rows=spec.rows // 4)
            paged = mod_paged.for_model(cfg, spec=spec, slots=2, max_len=14,
                                        resident_set=rs)
            assert paged.n_blocks == 2
            assert paged.alloc(0, 8) and paged.alloc(1, 8)
            for j, n_words in enumerate(pins):
                assert spec.plan(n_words).n_tiles == 1
                rs.pin(("w", j), argparse.Namespace(n_bits=8, n_words=n_words))
            if fits:
                assert rs.evictions == 0 and len(rs) == 114 + 2
                assert rs.rows_per_bank() == {0: 114 * 8 + 16, 1: 16}
                assert 114 * 8 + 16 <= spec.rows - rs.reserve_rows == 1536
            else:
                assert rs.evictions == 114 - (768 - 16) // 8
    TLEDGER.reset()
    RLEDGER.reset()


def test_cuda_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--preset", "reduced", "--slots", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(T_GEMMA.reduced())
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({}, T_GEMMA.reduced())
    assert resolve_device("cpu").type == "cpu"


def test_full_width_residency_bookkeeping_with_ecc():
    """With ECC-protected pins (the chaos phase) each full-width decode
    weight pin also holds its 5 parity planes: 13 rows a tile. gemma-2b's
    54 pins and KV blocks still fit bank 0's 768-row budget (54 x 13 + 16
    = 718), recurrentgemma-9b's 114 fit its 1536 (1498): the arrays stay
    as they are without ECC."""
    for cfg, slots, max_len, n_pins in ((T_GEMMA, 2, 16, 54),
                                        (T_RG, 2, 14, 114)):
        plain = tserve.resident_array_spec(with_cim(cfg, 8), slots, max_len)
        ecc = tserve.resident_array_spec(with_cim(cfg, 8), slots, max_len,
                                         ecc=True)
        assert ecc == plain
        assert n_pins * 13 + 16 <= ecc.rows - ecc.rows // 4
    # a model whose ECC rows would not fit gets more rows
    tight = dataclasses.replace(with_cim(T_GEMMA, 8), n_layers=30)
    assert tserve.resident_array_spec(tight, 2, 16, ecc=True).rows == 2048
    assert tserve.resident_array_spec(tight, 2, 16).rows == 1024


# ---------------------------------------------------------------------------
# chaos, admission control and the ADRA sampler, against the reference engine
# ---------------------------------------------------------------------------

#: the reference's chaos-test model (tests/test_serve_engine.py)
CHAOS_KW = dict(name="serve-chaos-test", family="dense", n_layers=1,
                d_model=16, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=32,
                vocab_size=64, dtype="float32", tensor_parallel=False,
                cim_mlp_bits=8, cim_attention_bits=8, cim_unroll_groups=True,
                cim_resident=True)


def _fresh_both():
    """Both packages' CiM state reset, as the reference test's `_fresh_cim`
    does (the reference's compiled programs are kept: they only save
    compile time, and no count compared here reads them)."""
    from repro.cim import cost as rcost
    from repro.cim import faults as rfaults
    from repro_torch.cim import faults as tfaults
    RLEDGER.reset()
    rarray.clear_resident()
    rcost.reset_plan_stats()
    rarray.set_current_spec(None)
    rarray.set_resident_ecc(False)
    rfaults.uninstall()
    rfaults.reset_fault_stats()
    tserve.fresh_cim_state()
    tarray.set_resident_ecc(False)
    tfaults.uninstall()


class _ChaosEnv:
    """One reference model and its port twin (the same weights), the
    reference's jitted prefill per max_len shared across its engines, the
    reference's prompts, and a memo of reference outcomes."""

    def __init__(self, cim: bool = True):
        kw = dict(CHAOS_KW) if cim else dict(
            CHAOS_KW, cim_mlp_bits=0, cim_attention_bits=0,
            cim_resident=False, name="serve-admission-test")
        self.rcfg, self.tcfg = RArch(**kw), TArch(**kw)
        self.rmodel = rbuild(self.rcfg)
        self.rparams = self.rmodel.init(jax.random.PRNGKey(1))
        self.tmodel = Model(self.tcfg, params=params_from_jax(
            jax.tree.map(np.asarray, self.rparams), self.tcfg, device="cpu"))
        self._prefill = {}
        self.memo = {}

    def prefill(self, max_len):
        from repro.train import make_prefill_step
        if max_len not in self._prefill:
            self._prefill[max_len] = jax.jit(make_prefill_step(self.rmodel,
                                                               max_len))
        return self._prefill[max_len]

    def prompts(self, n, prompt_len):
        from repro.launch import serve as rserve
        ns = argparse.Namespace(cfg=self.rcfg, key=jax.random.PRNGKey(0))
        return [np.asarray(rserve.ServeEngine._prompt_inputs(
            ns, rserve.ServeRequest(rid=i, prompt_len=prompt_len, gen=1))[
            "tokens"])[0].tolist() for i in range(n)]


@pytest.fixture(scope="module")
def chaos_env():
    return _ChaosEnv()


def _outcome(rep, engine, requests, fm):
    return {"tokens": [r["token_ids"] for r in rep["per_request"]],
            "faults": rep.get("faults"), "completed": rep["completed"],
            "shed": rep["shed"], "failovers": engine.failovers,
            "repairs": [r.repairs for r in requests],
            "disabled": engine.spec.disabled_banks,
            "fm": fm.stats() if fm is not None else None,
            "kv_banks": sorted(engine.paged.rs.rows_per_bank())}


def _run_ref(env, gen, fault_cfg=None, ecc=False, **kw):
    from repro.cim import faults as rfaults
    from repro.launch import serve as rserve
    if ecc:
        # trace the reference's lowerings with ECC off first, as its own
        # tests and CLI do (`ref_lowering` drops them after each test): its
        # plan_offload raises on a reshape (n_bits 0) while registry ECC is
        # on (ROADMAP C)
        env.memo[f"clean{gen}"] = _run_ref(env, gen)
    _fresh_both()
    if ecc:
        rarray.set_resident_ecc(True)
    try:
        spec = rarray.DEFAULT_SPEC
        paged = RPaged.for_model(env.rcfg, spec=spec, slots=2,
                                 max_len=4 + gen,
                                 resident_set=rarray.resident_set(spec))
        eng = rserve.ServeEngine(env.rmodel, env.rparams, slots=2,
                                 max_len=4 + gen, cim_lower=True, paged=paged,
                                 warmup_steps=0, spec=spec, **kw)
        eng.prefill_fn = env.prefill(4 + gen)
        reqs = [rserve.ServeRequest(rid=i, prompt_len=4, gen=gen)
                for i in range(2)]
        if fault_cfg is None:
            return _outcome(eng.run(reqs), eng, reqs, None)
        with rfaults.faults(rfaults.FaultConfig(**fault_cfg)) as fm:
            return _outcome(eng.run(reqs), eng, reqs, fm)
    finally:
        _fresh_both()


def _run_port(env, gen, fault_cfg=None, ecc=False, **kw):
    from repro_torch.cim import faults as tfaults
    _fresh_both()
    if ecc:
        tarray.set_resident_ecc(True)
    try:
        spec = tarray.DEFAULT_SPEC
        paged = TPaged.for_model(env.tcfg, spec=spec, slots=2,
                                 max_len=4 + gen,
                                 resident_set=tarray.resident_set(spec))
        eng = tserve.ServeEngine(env.tmodel, slots=2, max_len=4 + gen,
                                 cim_lower=True, paged=paged, warmup_steps=0,
                                 spec=spec, **kw)
        reqs = [tserve.ServeRequest(rid=i, prompt_len=4, gen=gen, prompt=p)
                for i, p in enumerate(env.prompts(2, 4))]
        if fault_cfg is None:
            return _outcome(eng.run(reqs), eng, reqs, None)
        with tfaults.faults(tfaults.FaultConfig(**fault_cfg)) as fm:
            return _outcome(eng.run(reqs), eng, reqs, fm)
    finally:
        _fresh_both()


def _ref(env, key, *args, **kw):
    if key not in env.memo:
        env.memo[key] = _run_ref(env, *args, **kw)
    return env.memo[key]


class TestChaos:
    """tests/test_serve_engine.py::TestChaos, each run through both
    engines on the same weights and prompts: tokens, the fault report
    (injected, detected, corrected, uncorrected, verifies, repairs,
    failovers, scrub, ECC counters) and the fault model's counters equal
    to the reference's."""

    def test_bit_exact_under_single_bit_resident_faults(self, chaos_env,
                                                        ref_lowering):
        cfg = dict(seed=11, resident_ber=1e-3, raise_on_uncorrectable=True)
        clean = _run_port(chaos_env, 4)
        assert clean["tokens"] == _ref(chaos_env, "clean4", 4)["tokens"]
        got = _run_port(chaos_env, 4, cfg, ecc=True)
        assert got == _ref(chaos_env, "ber", 4, cfg, ecc=True)
        assert got["tokens"] == clean["tokens"]
        fm = got["fm"]
        assert fm["injected"] > 0 and fm["corrected"] == fm["injected"]
        assert fm["uncorrected"] == 0
        assert got["faults"]["corrected"] > 0
        assert got["faults"]["uncorrected"] == 0
        assert got["faults"]["ecc_uncorrected"] == 0

    def test_uncorrectable_triggers_repair_and_retry(self, chaos_env,
                                                     ref_lowering):
        cfg = dict(seed=0, uncorrectable_at_verify=(2,),
                   raise_on_uncorrectable=True)
        got = _run_port(chaos_env, 4, cfg, ecc=True)
        assert got == _ref(chaos_env, "uncorrectable", 4, cfg, ecc=True)
        assert got["faults"]["repairs"] >= 1
        assert got["fm"]["uncorrected"] >= 1     # detected, then repaired
        assert got["tokens"] == _ref(chaos_env, "clean4", 4)["tokens"]

    def test_retry_budget_exhaustion_raises(self, chaos_env, ref_lowering):
        from repro.cim import faults as rfaults
        from repro_torch.cim import faults as tfaults
        cfg = dict(seed=0, uncorrectable_at_verify=tuple(range(200)),
                   raise_on_uncorrectable=True)
        with pytest.raises(tfaults.UncorrectableFaultError):
            _run_port(chaos_env, 4, cfg, ecc=True, retry_budget=1)
        with pytest.raises(rfaults.UncorrectableFaultError):
            _run_ref(chaos_env, 4, cfg, ecc=True, retry_budget=1)

    def test_mid_run_bank_kill_completes_all_requests(self, chaos_env,
                                                      ref_lowering):
        cfg = dict(seed=5, kill_bank_at=(2, 1))
        got = _run_port(chaos_env, 6, cfg)
        assert got == _ref(chaos_env, "kill1", 6, cfg)
        assert got["fm"]["bank_kills"] == 1 and got["failovers"] == 1
        assert got["disabled"] == (1,)
        assert tarray.spec_override() is None     # reset after the run
        assert all(len(t) == 6 for t in got["tokens"])
        assert got["completed"] == 2 and got["shed"] == 0
        assert got["faults"]["failovers"] == 1
        assert got["faults"]["uncorrected"] == 0
        assert got["faults"]["ecc_uncorrected"] == 0
        assert 1 not in got["kv_banks"]           # KV off the dead bank

    def test_bank_kill_tokens_match_healthy_run(self, chaos_env,
                                                ref_lowering):
        cfg = dict(seed=5, kill_bank_at=(2, 0))
        clean = _run_port(chaos_env, 6)
        assert clean == _ref(chaos_env, "clean6", 6)
        got = _run_port(chaos_env, 6, cfg)
        assert got == _ref(chaos_env, "kill0", 6, cfg)
        assert got["tokens"] == clean["tokens"]


@pytest.fixture(scope="module")
def float_env():
    return _ChaosEnv(cim=False)


def _admission(env, pkg, slots, n_reqs, **kw):
    """One float-path engine run of `n_reqs` requests (prompt 4, gen 3)."""
    if pkg == "ref":
        from repro.launch import serve as rserve
        eng = rserve.ServeEngine(env.rmodel, env.rparams, slots=slots,
                                 max_len=7, warmup_steps=0, **kw)
        reqs = [rserve.ServeRequest(rid=i, prompt_len=4, gen=3)
                for i in range(n_reqs)]
    else:
        eng = tserve.ServeEngine(env.tmodel, slots=slots, max_len=7,
                                 warmup_steps=0, **kw)
        reqs = [tserve.ServeRequest(rid=i, prompt_len=4, gen=3, prompt=p)
                for i, p in enumerate(env.prompts(n_reqs, 4))]
    rep = eng.run(reqs)
    return {"shed": rep["shed"], "shed_count": eng.shed_count,
            "completed": rep["completed"],
            "total_tokens": rep["total_tokens"],
            "decode_tokens": rep["decode_tokens"],
            "per_request": [(r["rid"], r["shed"], r["tokens"])
                            for r in rep["per_request"]],
            "done": [r.done for r in reqs], "p50": rep["p50_ms"] == 0.0,
            "tok_s": rep["tok_s_steady"] == 0.0}


class TestAdmissionControl:
    """tests/test_serve_engine.py::TestAdmissionControl through both engines
    on the same tiny float model: the same requests shed, completed and
    reported."""

    def test_timeout_sheds_stale_requests(self, float_env):
        got = _admission(float_env, "port", 1, 2, timeout_s=0.0)
        assert got == _admission(float_env, "ref", 1, 2, timeout_s=0.0)
        assert got["shed"] == got["shed_count"] == 1
        assert got["per_request"][1] == (1, True, 0)
        assert got["done"][0] and got["completed"] == 1

    def test_queue_limit_sheds_excess_from_tail(self, float_env):
        got = _admission(float_env, "port", 1, 4, queue_limit=1)
        assert got == _admission(float_env, "ref", 1, 4, queue_limit=1)
        # 1 admitted at once + 1 queued; the rest shed from the tail
        assert got["shed"] == 2 and sum(got["done"]) == 2
        assert got["per_request"][3][1]

    def test_all_shed_report_is_safe(self, float_env):
        kw = dict(queue_limit=0, timeout_s=0.0)
        got = _admission(float_env, "port", 0, 3, **kw)
        assert got == _admission(float_env, "ref", 0, 3, **kw)
        assert got["shed"] == 3 and got["completed"] == 0
        assert got["total_tokens"] == got["decode_tokens"] == 0
        assert got["p50"] and got["tok_s"]
        assert all(shed for _, shed, _ in got["per_request"])


def _select_level(a, b, ia, ib):
    take_b = a < b
    return jax.lax.select(take_b, b, a), jax.lax.select(take_b, ib, ia)


@pytest.fixture
def ref_select_level(monkeypatch):
    """The reference's sampler level as its lax.select twin (its jnp.where
    stays a host eqn under JAX 0.9: ROADMAP C), lowered afresh."""
    import repro.train.step as rstep
    from repro_torch.train import step as tstep
    monkeypatch.setattr(rstep, "_adra_level", _select_level)
    monkeypatch.setattr(rstep, "_ADRA_LEVEL_LOWERED", None)
    yield
    monkeypatch.setattr(rstep, "_ADRA_LEVEL_LOWERED", None)
    tstep._ADRA_LEVEL_LOWERED = None


@pytest.mark.parametrize("resident", [False, True])
def test_adra_sampler_decode_step_matches_reference(ref_lowering,
                                                    ref_select_level,
                                                    resident):
    """The bench config's decode step followed by the ADRA sampler: 188 + 8
    accesses (vocab 64 padded to 256 columns: eight levels of one access)
    and 10 + 8 dispatches; loads, per-op counts and the sampled tokens equal
    to the reference's."""
    from repro.train.step import adra_sample as r_adra
    from repro_torch.train import adra_sample as t_adra
    rcfg, tcfg = _bench_cfgs(resident)
    rmodel = rbuild(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(2))
    tmodel = Model(tcfg, params=params_from_jax(
        jax.tree.map(np.asarray, rparams), tcfg, device="cpu"))
    rcaches, tcaches = rmodel.init_caches(2, 8), tmodel.init_caches(2, 8)
    rstep = {"tokens": jnp.array([[1], [2]], jnp.int32),
             "positions": jnp.array([3, 5], jnp.int32)}
    tstep = {"tokens": torch.tensor([[1], [2]]),
             "positions": torch.tensor([3, 5], dtype=torch.int32)}
    rarray.clear_resident()
    for step in range(2):
        RLEDGER.reset()
        TLEDGER.reset()
        r0, t0 = rdisp.cache_stats(), tdisp.cache_stats()
        _, rlog = rmodel.decode_step(rparams, rcaches, rstep)
        rtok = np.asarray(r_adra(rlog))
        _, tlog = tmodel.decode_step(tcaches, tstep)
        ttok = t_adra(tlog)
        r1, t1 = rdisp.cache_stats(), tdisp.cache_stats()
        np.testing.assert_array_equal(ttok.numpy(), rtok)
        assert tcfg.vocab_padded == 256
        assert TLEDGER.accesses == RLEDGER.accesses == 188 + 8
        assert t1["dispatches"] - t0["dispatches"] == \
            r1["dispatches"] - r0["dispatches"] == 10 + 8
        for f in ("load_accesses", "load_words32", "resident_reuses",
                  "words32", "per_op"):
            assert getattr(TLEDGER, f) == getattr(RLEDGER, f), (step, f)


def test_serve_engine_adra_tokens_match_reference(ref_lowering,
                                                  ref_select_level):
    """`--sampler adra` through both engines at the bench config (2 slots,
    2 requests, prompt 4 + gen 4): the same tokens, and every port decode
    step 188 + 8 accesses and 10 + 8 dispatches (eight sampler levels)."""
    from repro.launch import serve as rserve
    from repro.train import make_prefill_step
    rcfg, tcfg = _bench_cfgs(True)
    rmodel = rbuild(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(2))
    rserve._fresh_cim_state()
    eng = rserve.ServeEngine(rmodel, rparams, slots=2, max_len=8,
                             sampler="adra", cim_lower=True, warmup_steps=1)
    eng.prefill_fn = make_prefill_step(rmodel, 8)
    rrep = eng.run([rserve.ServeRequest(rid=i, prompt_len=4, gen=4)
                    for i in range(2)])
    prompts = [np.asarray(eng._prompt_inputs(rserve.ServeRequest(
        rid=i, prompt_len=4, gen=4))["tokens"])[0].tolist() for i in range(2)]
    tmodel = Model(tcfg, params=params_from_jax(
        jax.tree.map(np.asarray, rparams), tcfg, device="cpu"))
    tserve.fresh_cim_state()
    teng = tserve.ServeEngine(tmodel, slots=2, max_len=8, sampler="adra",
                              cim_lower=True, warmup_steps=1)
    trep = teng.run([tserve.ServeRequest(rid=i, prompt_len=4, gen=4,
                                         prompt=prompts[i])
                     for i in range(2)])
    assert [r["token_ids"] for r in trep["per_request"]] == \
        [r["token_ids"] for r in rrep["per_request"]]
    assert set(trep["step_accesses"]) == {188 + 8}
    assert set(trep["step_dispatches"]) == {10 + 8}
    assert trep["decode_steps"] == rrep["decode_steps"] == 3
    with pytest.raises(ValueError, match="sampler"):
        tserve.ServeEngine(tmodel, slots=1, max_len=8, sampler="top-k")


def test_serve_main_chaos_phase_on_cpu(monkeypatch):
    """--sampler adra --cim-faults --scrub-every 2 on reduced gemma-2b: the
    chaos phase's tokens equal the fault-free resident run's, 0 bits stay
    uncorrected and ECC corrected what the resident BER flipped; every
    decode step adds the sampler's eight levels (vocab 256) to the greedy
    step's 202 accesses and 10 dispatches."""
    monkeypatch.setenv("REPRO_CIM_FAULT_SEED", "0")
    monkeypatch.setenv("REPRO_CIM_FAULT_RESIDENT_BER", "1e-4")
    out = tserve.main(["--preset", "reduced", "--device", "cpu", "--slots",
                       "2", "--requests", "2", "--prompt-len", "4", "--gen",
                       "3", "--cim-lower", "--cim-resident", "--sampler",
                       "adra", "--cim-faults", "--scrub-every", "2"])
    ph = out["phases"]
    assert out["sampler"] == "adra"
    chaos, resident = ph["chaos"], ph["resident"]
    assert [r["token_ids"] for r in chaos["per_request"]] == \
        [r["token_ids"] for r in resident["per_request"]]
    f = chaos["faults"]
    assert f["uncorrected"] == 0 and f["corrected"] == f["injected"] > 0
    assert f["scrub"]["scanned"] > 0 and f["ecc_verifies"] > 0
    assert "faults" not in resident
    assert tarray.spec_override() is None
    assert not tarray.resident_ecc_default()
    for name in ("repack", "resident", "chaos"):
        assert set(ph[name]["step_accesses"]) == {202 + 8}, name
        assert set(ph[name]["step_dispatches"]) == {10 + 8}, name
