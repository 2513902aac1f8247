"""Port vs reference: the hybrid RecurrentGemma stack on reduced
recurrentgemma-9b (6 layers: rec, rec, local, rec, rec, local; d_model 64;
local window 32).

Inputs and weights are made from seeds with numpy or by the reference's
init and handed to both packages. Float paths are held at atol 1e-5 per
block and 2e-4 for the whole model (the reference's
`test_decode_matches_teacher_forcing` tolerance); CiM counts are exact.
Where the reference lowers to CiM, the `jax.core.Literal`/`Var` aliases it
needs under JAX 0.9 are applied inside the test only.
"""
import dataclasses
from pathlib import Path

import jax
import jax.extend.core as jex
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cim import dispatch as rdisp
from repro.cim.accounting import LEDGER as RLEDGER
from repro.configs.registry import RECURRENTGEMMA_9B as R_RG
from repro.models import attention as rattn
from repro.models import build as rbuild
from repro.models import layers as rlayers
from repro.models import recurrent as rrec
from repro_torch.cim import array as tarray
from repro_torch.cim import dispatch as tdisp
from repro_torch.cim.accounting import LEDGER as TLEDGER
from repro_torch.configs.registry import RECURRENTGEMMA_9B as T_RG
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import recurrent as trec
from repro_torch.models.model import Model, with_cim

BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
#: the reference's prefill/decode-vs-forward tolerance
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh_state():
    for clear in (TLEDGER.reset, tarray.clear_resident,
                  tdisp.clear_schedule_cache, rdisp.clear_schedule_cache,
                  RLEDGER.reset):
        clear()
    yield
    for clear in (TLEDGER.reset, tarray.clear_resident,
                  tdisp.clear_schedule_cache, rdisp.clear_schedule_cache,
                  RLEDGER.reset):
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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_reduced_config_matches_reference():
    r, t = R_RG.reduced(), T_RG.reduced()
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "local_window", "block_pattern",
              "gating", "dtype"):
        assert getattr(t, f) == getattr(r, f), f
    assert (t.n_layers, t.d_model, t.local_window) == (6, 64, 32)
    assert t.pattern_layers() == ("rec", "rec", "local") * 2
    assert T_RG.pattern_layers().count("rec") == 26
    assert T_RG.pattern_layers().count("local") == 12


def test_rglru_block_matches_reference_prefill_then_decode():
    cfg_r, cfg_t = R_RG.reduced(), T_RG.reduced()
    p = _np(rrec.rglru_block_init(jax.random.PRNGKey(3), cfg_r, jnp.float32))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, cfg_t.d_model)).astype(np.float32)
    block = jax.jit(rrec.rglru_block_apply, static_argnums=1)
    ry, rs = block(p, cfg_r, jnp.asarray(x))
    ty, ts = trec.rglru_block_apply(_t(p), cfg_t, torch.from_numpy(x))
    _close(ty, ry, BLOCK_TOL)
    for k in ("h", "conv"):
        _close(ts[k], rs[k], BLOCK_TOL)
    assert ts["h"].dtype == torch.float32
    x1 = rng.normal(size=(2, 1, cfg_t.d_model)).astype(np.float32)
    ry1, rs1 = block(p, cfg_r, jnp.asarray(x1), rs)
    ty1, ts1 = trec.rglru_block_apply(_t(p), cfg_t, torch.from_numpy(x1), ts)
    _close(ty1, ry1, BLOCK_TOL)
    for k in ("h", "conv"):
        _close(ts1[k], rs1[k], BLOCK_TOL)
    state = trec.rglru_make_state(cfg_t, 2, torch.float32, "cpu")
    assert state["h"].shape == (2, 64) and state["conv"].shape == (2, 3, 64)


@pytest.mark.parametrize("t_prompt", [5, 40])
def test_local_attention_matches_reference(t_prompt):
    """Prefill shorter than and past the 32-token window (ring layout), then
    two decode steps, the second one wrapping the ring further."""
    cfg_r, cfg_t = R_RG.reduced(), T_RG.reduced()
    p = _np(rattn.gqa_init(jax.random.PRNGKey(4), cfg_r, jnp.float32))
    tp = _t(p)
    rng = np.random.default_rng(t_prompt)
    x = rng.normal(size=(2, t_prompt, cfg_t.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t_prompt, dtype=np.int32)[None],
                          (2, t_prompt))
    _close(tattn.local_apply(tp, cfg_t, torch.from_numpy(x),
                             torch.from_numpy(pos.copy())),
           jax.jit(rattn.local_apply, static_argnums=1)(
               p, cfg_r, jnp.asarray(x), jnp.asarray(pos)),
           BLOCK_TOL)
    ry, rc = jax.jit(rattn.local_prefill, static_argnums=1)(
        p, cfg_r, jnp.asarray(x), jnp.asarray(pos))
    decode = jax.jit(rattn.local_decode, static_argnums=1)
    ty, tc = tattn.local_prefill(tp, cfg_t, torch.from_numpy(x),
                                 torch.from_numpy(pos.copy()))
    _close(ty, ry, BLOCK_TOL)
    for k in ("k", "v"):
        assert tc[k].shape == (2, 32, 1, 16)
        _close(tc[k], rc[k], BLOCK_TOL)
    for step in range(2):
        x1 = rng.normal(size=(2, 1, cfg_t.d_model)).astype(np.float32)
        at = np.array([t_prompt + step, t_prompt + 3 * step], np.int32)
        ry, rc = decode(p, cfg_r, jnp.asarray(x1), rc, jnp.asarray(at))
        ty, tc = tattn.local_decode(tp, cfg_t, torch.from_numpy(x1), tc,
                                    torch.from_numpy(at))
        _close(ty, ry, BLOCK_TOL)
        for k in ("k", "v"):
            _close(tc[k], rc[k], BLOCK_TOL)


@pytest.fixture(scope="module")
def ref_params():
    """The reference's reduced-hybrid parameters (seed 0), as numpy."""
    return _np(rbuild(R_RG.reduced()).init(jax.random.PRNGKey(0)))


def _models(np_params, rcfg=None, tcfg=None):
    rcfg = rcfg or R_RG.reduced()
    tcfg = tcfg or T_RG.reduced()
    rparams = jax.tree.map(jnp.asarray, np_params)
    tmodel = Model(tcfg, params=params_from_jax(np_params, tcfg,
                                                device="cpu"))
    return rbuild(rcfg), rparams, tmodel


def test_params_from_jax_unstacks_the_hybrid_in_stack_order(ref_params):
    rmodel, rparams, tmodel = _models(ref_params)
    assert tmodel.kinds == T_RG.reduced().pattern_layers()
    for li, (kind, layer) in enumerate(zip(tmodel.kinds, tmodel.layers)):
        mixer = "rec" if kind == "rec" else "attn"
        assert set(layer.names) == {"ln1", mixer, "ln2", "mlp"}, li
        g, pos = divmod(li, 3)
        want = np.asarray(rparams["groups"][pos][mixer]["w_out" if mixer ==
                                                         "rec" else "wo"][g])
        got = getattr(layer, mixer)["w_out" if mixer == "rec" else "wo"]
        np.testing.assert_array_equal(got.numpy(), want)


def test_prefill_and_decode_match_reference_model(ref_params):
    """Prefill 7 tokens, then 3 decode steps: logits at the reference's
    teacher-forcing tolerance."""
    rmodel, rparams, tmodel = _models(ref_params)
    toks = np.random.default_rng(5).integers(0, 256, (2, 10)).astype(np.int32)
    prefill = jax.jit(rmodel.prefill, static_argnums=2)
    decode = jax.jit(rmodel.decode_step)
    rc, rlog = prefill(rparams, {"tokens": jnp.asarray(toks[:, :7])}, 10)
    tc, tlog = tmodel.prefill({"tokens": torch.from_numpy(toks[:, :7])
                               .long()}, max_len=10)
    _close(tlog, rlog, MODEL_TOL)
    for t in range(7, 10):
        rc, rlog = decode(rparams, rc, {
            "tokens": jnp.asarray(toks[:, t:t + 1]),
            "positions": jnp.full((2,), t, jnp.int32)})
        tc, tlog = tmodel.decode_step(tc, {
            "tokens": torch.from_numpy(toks[:, t:t + 1]).long(),
            "positions": torch.full((2,), t, dtype=torch.int32)})
        _close(tlog, rlog, MODEL_TOL)


def test_lowered_decode_step_counts_match_reference(ref_lowering, ref_params):
    """One int8 CiM decode step at 2 slots: 6 layers x 3 MLP contractions,
    (2*8-1) + log2 K accesses each over K = 64, 64, 128 = 384 accesses and
    18 dispatches, the reference's; local attention and RG-LRU are float."""
    rcfg = dataclasses.replace(R_RG.reduced(), cim_mlp_bits=8,
                               cim_attention_bits=8, cim_unroll_groups=True)
    rmodel, rparams, tmodel = _models(ref_params, rcfg,
                                      with_cim(T_RG.reduced(), 8))
    rcaches = rmodel.init_caches(2, 8)
    tcaches = tmodel.init_caches(2, 8)
    r0, t0 = rdisp.cache_stats(), tdisp.cache_stats()
    _, rlog = rmodel.decode_step(rparams, rcaches, {
        "tokens": jnp.array([[1], [2]], jnp.int32),
        "positions": jnp.array([3, 5], jnp.int32)})
    _, tlog = tmodel.decode_step(tcaches, {
        "tokens": torch.tensor([[1], [2]]),
        "positions": torch.tensor([3, 5], dtype=torch.int32)})
    r1, t1 = rdisp.cache_stats(), tdisp.cache_stats()
    assert TLEDGER.accesses == RLEDGER.accesses == 384
    assert t1["dispatches"] - t0["dispatches"] == \
        r1["dispatches"] - r0["dispatches"] == 18
    for f in ("load_accesses", "words32", "per_op"):
        assert getattr(TLEDGER, f) == getattr(RLEDGER, f), f
    _close(tlog, rlog, MODEL_TOL)


def test_insert_lands_recurrent_state_and_ring_in_a_reused_slot():
    """A batch-1 prefill inserted into a slot whose previous request left
    its state behind: the slot's recurrent state and ring buffer become the
    prefill's, and the next decode step gives that row the logits of the
    batch-1 caches."""
    model = Model(T_RG.reduced(), device="cpu", seed=4)
    engine = tserve.ServeEngine(model, slots=2, max_len=40)
    caches = model.init_caches(2, 40)
    for c in caches:                      # a retired request's leftovers
        for v in c.values():
            v.normal_()
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (1, 35))).long()
    single, _ = model.prefill({"tokens": toks}, max_len=40)
    engine._insert(caches, single, 1)
    for kind, c, s in zip(model.kinds, caches, single):
        assert set(c) == ({"h", "conv"} if kind == "rec" else {"k", "v"})
        for name in c:
            assert torch.equal(c[name][1], s[name][0]), (kind, name)
    step = {"tokens": torch.tensor([[3], [7]]),
            "positions": torch.tensor([9, 35], dtype=torch.int32)}
    _, logits = model.decode_step(caches, step)
    _, want = model.decode_step(single, {"tokens": torch.tensor([[7]]),
                                         "positions": torch.tensor(
                                             [35], dtype=torch.int32)})
    torch.testing.assert_close(logits[1:], want, rtol=1e-5, atol=1e-5)


def test_serve_engine_tokens_equal_host_twin_with_slot_reuse():
    """3 requests on 2 slots (the third reuses a retired slot): the int8
    CiM serve gives the host twin's greedy tokens, every decode step
    charges 384 accesses and 18 dispatches."""
    cfg = with_cim(T_RG.reduced(), 8)
    model = Model(cfg, device="cpu", seed=3)
    args = tserve.parse_args(["--arch", "recurrentgemma-9b", "--device",
                              "cpu", "--slots", "2", "--requests", "3",
                              "--prompt-len", "6", "--gen", "3",
                              "--cim-lower"])
    cim = tserve.serve_once(model, args)
    twin = tserve.serve_once(
        model.derive(dataclasses.replace(cfg, cim_host_twin=True)), args)
    assert [r["token_ids"] for r in cim["per_request"]] == \
        [r["token_ids"] for r in twin["per_request"]]
    assert [len(r["token_ids"]) for r in cim["per_request"]] == [3, 3, 3]
    assert set(cim["step_accesses"]) == {384}
    assert set(cim["step_dispatches"]) == {18}


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    for f in files:
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "repro"), (f, line)
