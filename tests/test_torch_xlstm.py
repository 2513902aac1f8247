"""Port vs reference: the xLSTM stack on reduced xlstm-125m (8 layers:
mlstm, mlstm, mlstm, slstm, twice; d_model 64; 4 heads; float32).

Inputs and weights are made from seeds with numpy or by the reference's
init and handed to both packages. Blocks are held at atol 1e-5, the whole
model at 2e-4 (the reference's `test_decode_matches_teacher_forcing`
tolerance), greedy tokens exactly. No reference path here goes through
its lowering compiler.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import XLSTM_125M as R_X
from repro.models import build as rbuild
from repro.models import xlstm as rx
from repro_torch.cim import array as tarray
from repro_torch.cim import dispatch as tdisp
from repro_torch.cim.accounting import LEDGER as TLEDGER
from repro_torch.configs.registry import XLSTM_125M as T_X
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import xlstm as tx
from repro_torch.models.model import Model

BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
#: the reference's prefill/decode-vs-forward tolerance
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _fresh_state():
    """A clean port ledger and caches, and one intra-op thread (see
    tests/test_torch_rglru.py: the first multithreaded `torch.exp` of a
    fresh process on a virtual machine with AVX-512 was seen to be off by
    about 1e-4)."""
    for clear in (TLEDGER.reset, tarray.clear_resident,
                  tdisp.clear_schedule_cache):
        clear()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    for clear in (TLEDGER.reset, tarray.clear_resident,
                  tdisp.clear_schedule_cache):
        clear()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_reduced_config_matches_reference():
    r, t = R_X.reduced(), T_X.reduced()
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "block_pattern", "gating", "dtype",
              "family", "tie_embeddings"):
        assert getattr(t, f) == getattr(r, f), f
    assert (t.n_layers, t.d_model, t.n_heads, t.dtype) == (8, 64, 4,
                                                           "float32")
    assert t.pattern_layers() == ("mlstm",) * 3 + ("slstm",) + \
        ("mlstm",) * 3 + ("slstm",)
    assert T_X.pattern_layers().count("slstm") == 3
    assert (T_X.d_model, T_X.vocab_padded, T_X.tie_embeddings) == \
        (768, 50432, False)


@pytest.mark.parametrize("t", [1, 8, 320])
def test_mlstm_apply_matches_reference(t):
    """From the zero state: T < 32 takes the sequential cell, T = 320 the
    chunkwise form with chunk 160, two chunks, the carry crossing."""
    cfg_r, cfg_t = R_X.reduced(), T_X.reduced()
    p = _np(rx.mlstm_init(jax.random.PRNGKey(1), cfg_r, jnp.float32))
    x = np.random.default_rng(t).normal(
        size=(2, t, cfg_t.d_model)).astype(np.float32)
    ry, rs = jax.jit(rx.mlstm_apply, static_argnums=1)(p, cfg_r,
                                                       jnp.asarray(x))
    ty, ts = tx.mlstm_apply(_t(p), cfg_t, torch.from_numpy(x))
    _close(ty, ry, BLOCK_TOL)
    for name, want in zip(("C", "n", "m"), rs):
        assert ts[name].dtype == torch.float32
        _close(ts[name], want, BLOCK_TOL)
    if t == 320:
        assert tx.pick_chunk(320) == 160


def test_mlstm_decode_from_prefill_state():
    """A 40-token chunkwise prefill, then two sequential decode steps that
    carry its state, against the reference; the state keeps the shapes of
    `mlstm_make_state`."""
    cfg_r, cfg_t = R_X.reduced(), T_X.reduced()
    p = _np(rx.mlstm_init(jax.random.PRNGKey(2), cfg_r, jnp.float32))
    tp = _t(p)
    rng = np.random.default_rng(3)
    apply = jax.jit(rx.mlstm_apply, static_argnums=1)
    x = rng.normal(size=(2, 40, cfg_t.d_model)).astype(np.float32)
    _, rs = apply(p, cfg_r, jnp.asarray(x))
    _, ts = tx.mlstm_apply(tp, cfg_t, torch.from_numpy(x))
    empty = tx.mlstm_make_state(cfg_t, 2, "cpu")
    assert {k: tuple(v.shape) for k, v in empty.items()} == \
        {"C": (2, 4, 32, 32), "n": (2, 4, 32), "m": (2, 4)}
    assert bool(torch.isneginf(empty["m"]).all())
    for k in empty:
        assert ts[k].shape == empty[k].shape
    for _ in range(2):
        x1 = rng.normal(size=(2, 1, cfg_t.d_model)).astype(np.float32)
        ry, rs = apply(p, cfg_r, jnp.asarray(x1), rs)
        ty, ts = tx.mlstm_apply(tp, cfg_t, torch.from_numpy(x1), ts)
        _close(ty, ry, BLOCK_TOL)
        for name, want in zip(("C", "n", "m"), rs):
            _close(ts[name], want, BLOCK_TOL)


@pytest.mark.parametrize("weights", ["float32", "bfloat16"])
def test_slstm_apply_matches_reference(weights):
    """A 9-token prefill then one decode step. With bfloat16 R and b (the
    full-width path's compute cast) both packages promote the recurrence
    to float32."""
    cfg_r, cfg_t = R_X.reduced(), T_X.reduced()
    p = _np(rx.slstm_init(jax.random.PRNGKey(4), cfg_r, jnp.float32))
    rp = jax.tree.map(jnp.asarray, p)
    tp = _t(p)
    if weights == "bfloat16":
        for name in ("r_gates", "b_gates"):
            rp[name] = rp[name].astype(jnp.bfloat16)
            tp[name] = tp[name].to(torch.bfloat16)
    rng = np.random.default_rng(5)
    apply = jax.jit(rx.slstm_apply, static_argnums=1)
    x = rng.normal(size=(2, 9, cfg_t.d_model)).astype(np.float32)
    ry, rs = apply(rp, cfg_r, jnp.asarray(x))
    ty, ts = tx.slstm_apply(tp, cfg_t, torch.from_numpy(x))
    _close(ty, ry, BLOCK_TOL)
    names = ("h", "c", "n", "m")
    for name, want in zip(names, rs):
        assert ts[name].dtype == torch.float32
        _close(ts[name], want, BLOCK_TOL)
    x1 = rng.normal(size=(2, 1, cfg_t.d_model)).astype(np.float32)
    ry, rs = apply(rp, cfg_r, jnp.asarray(x1), rs)
    ty, ts = tx.slstm_apply(tp, cfg_t, torch.from_numpy(x1), ts)
    _close(ty, ry, BLOCK_TOL)
    for name, want in zip(names, rs):
        _close(ts[name], want, BLOCK_TOL)
    empty = tx.slstm_make_state(cfg_t, 2, "cpu")
    assert [float(empty[k].abs().max()) for k in names] == [0.0, 0.0, 1.0,
                                                           0.0]
    assert float(empty["n"].min()) == 1.0


@pytest.fixture(scope="module")
def ref_params():
    """The reference's reduced-xLSTM parameters (seed 0), as numpy."""
    return _np(rbuild(R_X.reduced()).init(jax.random.PRNGKey(0)))


def _models(np_params):
    rparams = jax.tree.map(jnp.asarray, np_params)
    cfg = T_X.reduced()
    tmodel = Model(cfg, params=params_from_jax(np_params, cfg, device="cpu"))
    return rbuild(R_X.reduced()), rparams, tmodel


def test_params_from_jax_unstacks_two_groups_of_four(ref_params):
    _, rparams, tmodel = _models(ref_params)
    assert len(rparams["groups"]) == 4
    assert tmodel.kinds == T_X.reduced().pattern_layers()
    for li, (kind, layer) in enumerate(zip(tmodel.kinds, tmodel.layers)):
        assert set(layer.names) == {"ln1", "cell"}, li
        g, pos = divmod(li, 4)
        name = "w_up" if kind == "mlstm" else "r_gates"
        cell = layer.tree()["cell"]
        np.testing.assert_array_equal(
            cell[name].numpy(),
            np.asarray(rparams["groups"][pos]["cell"][name][g]))
        norm = "out_norm" if kind == "mlstm" else "ffn_norm"
        width = 128 if kind == "mlstm" else 64
        assert cell[norm]["scale"].shape == (width,)


@pytest.mark.parametrize("prompt", [7, 40])
def test_prefill_and_decode_match_reference_model(ref_params, prompt):
    """Prefill (sequential mLSTM below 32 tokens, chunkwise from 32), then
    3 decode steps: logits at the reference's teacher-forcing
    tolerance."""
    rmodel, rparams, tmodel = _models(ref_params)
    total = prompt + 3
    toks = np.random.default_rng(prompt).integers(
        0, 256, (2, total)).astype(np.int32)
    rc, rlog = jax.jit(rmodel.prefill, static_argnums=2)(
        rparams, {"tokens": jnp.asarray(toks[:, :prompt])}, total)
    tc, tlog = tmodel.prefill({"tokens": torch.from_numpy(
        toks[:, :prompt]).long()}, max_len=total)
    _close(tlog, rlog, MODEL_TOL)
    decode = jax.jit(rmodel.decode_step)
    for t in range(prompt, total):
        rc, rlog = decode(rparams, rc, {
            "tokens": jnp.asarray(toks[:, t:t + 1]),
            "positions": jnp.full((2,), t, jnp.int32)})
        tc, tlog = tmodel.decode_step(tc, {
            "tokens": torch.from_numpy(toks[:, t:t + 1]).long(),
            "positions": torch.full((2,), t, dtype=torch.int32)})
        _close(tlog, rlog, MODEL_TOL)


def _reference_greedy(rmodel, rparams, prompt, gen, max_len):
    """The reference Model's prefill and greedy decode loop, batch 1."""
    rc, logits = jax.jit(rmodel.prefill, static_argnums=2)(
        rparams, {"tokens": jnp.asarray([prompt], jnp.int32)}, max_len)
    decode = jax.jit(rmodel.decode_step)
    out = [int(jnp.argmax(logits[0]))]
    for i in range(gen - 1):
        rc, logits = decode(rparams, rc, {
            "tokens": jnp.asarray([[out[-1]]], jnp.int32),
            "positions": jnp.asarray([len(prompt) + i], jnp.int32)})
        out.append(int(jnp.argmax(logits[0])))
    return out


def test_serve_engine_tokens_equal_reference_model(ref_params):
    """3 requests on 2 slots (the third lands in a retired request's slot,
    whose state it overwrites), prompts of 6 and 35 tokens: the float serve
    engine gives the reference Model's greedy tokens, launches no fused
    kernel access and charges nothing."""
    rmodel, rparams, tmodel = _models(ref_params)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, n).tolist() for n in (6, 35, 6)]
    gen = 4
    max_len = 35 + gen
    reqs = [tserve.ServeRequest(rid=i, prompt_len=len(p), gen=gen, prompt=p)
            for i, p in enumerate(prompts)]
    engine = tserve.ServeEngine(tmodel, slots=2, max_len=max_len)
    rep = engine.run(reqs)
    assert rep["completed"] == 3
    assert [r.slot for r in reqs] == [0, 1, 0]
    want = [_reference_greedy(rmodel, rparams, p, gen, max_len)
            for p in prompts]
    assert [r["token_ids"] for r in rep["per_request"]] == want
    assert TLEDGER.accesses == 0 and TLEDGER.load_accesses == 0


def test_cim_lower_fails_as_the_reference_does():
    """xLSTM layers have no MLP and no global attention, so nothing lowers
    to CiM: both phases charge 0 accesses and the resident phase fails the
    reference's strictly-fewer assertion with the reference's message."""
    argv = ["--arch", "xlstm-125m", "--preset", "reduced", "--device",
            "cpu", "--slots", "2", "--requests", "3", "--prompt-len", "8",
            "--gen", "4", "--cim-lower", "--cim-resident"]
    with pytest.raises(AssertionError) as err:
        tserve.main(argv)
    assert str(err.value) == ("resident serving must charge strictly fewer "
                              "total accesses/token: 0.0 !< 0.0")
    assert TLEDGER.accesses == 0 and TLEDGER.total_accesses == 0
    cfg = dataclasses.replace(T_X.reduced(), cim_mlp_bits=8)
    assert tserve._decode_weight_pins(cfg, 2) == []
