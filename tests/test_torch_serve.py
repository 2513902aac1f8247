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
