"""Port vs reference: the train path, optimizer, data, checkpoints, runtime.

Inputs come from numpy (or the reference's own init, carried over with
`params_from_jax`) and go through both packages; reference calls run
under `jax.jit`. On the CPU the port's attention is `mha_ref` forward with
the blockwise backward; the reference's train forward attends densely at
16 tokens and blockwise at 1024. The checkpoint and supervisor cases mirror
tests/test_runtime.py on the port's own state (its parameters are updated
in place, so each run builds its own model).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.data import DataConfig as RDataConfig
from repro.data import synthetic_batch as r_synthetic_batch
from repro.models import build as r_build
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw as r_adamw
from repro.optim import compression as r_comp
from repro.train import init_state as r_init_state
from repro.train import make_train_step as r_make_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_jax
from repro_torch.data import DataConfig, synthetic_batch
from repro_torch.models.model import Model, build
from repro_torch import tree
from repro_torch.optim import AdamWConfig, adamw, compression
from repro_torch.runtime import (SimulatedHostFailure, StragglerDetector,
                                 Supervisor, SupervisorConfig)
from repro_torch.train import init_state, make_eval_step, make_train_step
from repro_torch.train.step import accumulate_grads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R_G = r_get_config("gemma-2b").reduced()
T_G = t_get_config("gemma-2b").reduced()
#: float32 losses and gradients of the same model in two frameworks
#: (sums in other orders; 1024 tokens reach the reference's jitted RoPE,
#: whose frequencies sit one ulp off: tests/test_torch_flash.py)
LOSS_TOL = dict(atol=1e-5, rtol=1e-6)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One intra-op thread: deterministic sums (the supervisor cases compare
    runs bit for bit) and none of the first-`torch.exp` drift seen on this
    kind of machine (tests/test_torch_rglru.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_params():
    """The reference's reduced gemma-2b parameters (seed 0), as numpy."""
    return jax.tree.map(np.asarray, r_build(R_G).init(jax.random.PRNGKey(0)))


def _tmodel(np_params, cfg=T_G):
    return Model(cfg, params=params_from_jax(np_params, cfg, device="cpu"))


def _batch(seed, b, s, vocab=256):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "targets": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def _grads_like_port(np_grads, cfg=T_G):
    """The reference's gradient tree in the port's layout, as leaves."""
    return tree.leaves(params_from_jax(np_grads, cfg, device="cpu"))


@pytest.mark.parametrize("s", [16, 1024])
def test_loss_and_every_gradient_match_reference(ref_params, s):
    """`Model.loss` and every parameter's gradient against
    `jax.value_and_grad(model.loss)` on the same weights."""
    batch = _batch(s, 2, s)
    rmodel = r_build(R_G)
    (rl, rparts), rg = jax.jit(jax.value_and_grad(rmodel.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, ref_params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tm = _tmodel(ref_params)
    for p in tm.parameters():
        p.requires_grad_(True)
    loss, parts = tm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(rl), **LOSS_TOL)
    np.testing.assert_allclose(float(parts["ce"].detach()), float(rparts["ce"]),
                               **LOSS_TOL)
    assert float(parts["aux"]) == float(rparts["aux"]) == 0.0
    want = _grads_like_port(jax.tree.map(np.asarray, rg))
    got = tree.leaves(tm.params())
    assert len(got) == len(want) == 2 * 9 + 2
    for p, g in zip(got, want):
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), **GRAD_TOL)


def test_forward_logits_match_reference(ref_params):
    """`Model.forward`: full float32 logits over the padded vocab and aux."""
    batch = _batch(6, 2, 16)
    rlogits, raux = jax.jit(r_build(R_G).forward)(
        jax.tree.map(jnp.asarray, ref_params),
        {"tokens": jnp.asarray(batch["tokens"])})
    logits, aux = _tmodel(ref_params)({"tokens": torch.from_numpy(
        batch["tokens"])})
    assert logits.dtype == torch.float32
    assert logits.shape == (2, 16, R_G.vocab_padded)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(rlogits),
                               atol=1e-5, rtol=1e-5)
    assert float(aux) == float(raux) == 0.0


def _grads(model, batch, n_micro=1):
    for p in model.parameters():
        p.requires_grad_(True)
        p.grad = None
    accumulate_grads(model, batch, n_micro)
    return [None if p.grad is None else p.grad.clone()
            for p in tree.leaves(model.params())]


def test_remat_on_and_off_give_equal_gradients(ref_params):
    batch = {k: torch.from_numpy(v) for k, v in _batch(1, 2, 24).items()}
    plain = _grads(_tmodel(ref_params), batch)
    cfg = dataclasses.replace(T_G, remat=True)
    remat = _grads(_tmodel(ref_params, cfg), batch)
    for a, b in zip(plain, remat):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_two_microbatches_equal_one(ref_params):
    """(loss_1 / 2).backward() + (loss_2 / 2).backward() is the gradient of
    the whole batch's mean loss."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(2, 4, 16).items()}
    one = _grads(_tmodel(ref_params), batch, 1)
    two = _grads(_tmodel(ref_params), batch, 2)
    for a, b in zip(one, two):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        accumulate_grads(_tmodel(ref_params), batch, 3)


def _tree(rng, dtype=np.float32):
    return {"a": rng.normal(size=(3, 4)).astype(dtype),
            "b": [rng.normal(size=(5,)).astype(dtype),
                  {"c": rng.normal(size=(2, 2, 3)).astype(dtype)}]}


@pytest.mark.parametrize("state_dtype,grad_clip", [
    ("float32", 1.0), ("float32", 100.0), ("bfloat16", 0.5)])
def test_adamw_update_matches_reference(state_dtype, grad_clip):
    """Two updates (and `clip_by_global_norm` on their gradients), clipping
    active or not, float32 or bfloat16 moments."""
    rng = np.random.default_rng(7)
    params = _tree(rng)
    rcfg = RAdamWConfig(lr=1e-2, grad_clip=grad_clip, state_dtype=state_dtype)
    tcfg = AdamWConfig(lr=1e-2, grad_clip=grad_clip, state_dtype=state_dtype)
    rp = jax.tree.map(jnp.asarray, params)
    rs = r_adamw.init(rp, rcfg)
    tp = tree.tree_map(torch.from_numpy, params)
    ts = adamw.init(tp, tcfg)
    for i in range(2):
        grads = _tree(rng)
        rc, rn = r_adamw.clip_by_global_norm(jax.tree.map(jnp.asarray, grads),
                                             grad_clip)
        tc, tn = adamw.clip_by_global_norm(
            tree.tree_map(torch.from_numpy, grads), grad_clip)
        np.testing.assert_allclose(float(tn), float(rn), rtol=1e-6)
        for g, w in zip(tree.leaves(tc), jax.tree.leaves(rc)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
        rp, rs, rm = jax.jit(lambda g, s, p: r_adamw.update(g, s, p, rcfg))(
            jax.tree.map(jnp.asarray, grads), rs, rp)
        tp, ts, tm = adamw.update(tree.tree_map(torch.from_numpy, grads),
                                  ts, tp, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        assert int(ts["count"]) == int(rs["count"]) == i + 1
        for got, want in ((tp, rp), (ts["m"], rs["m"]), (ts["v"], rs["v"])):
            for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
                assert str(g.dtype)[6:] == str(w.dtype)
                np.testing.assert_allclose(g.float().numpy(),
                                           np.asarray(w, np.float32),
                                           atol=1e-6, rtol=1e-5)


def test_cosine_schedule_matches_reference():
    r_lr = r_adamw.cosine_schedule(3e-4, warmup=5, total=40)
    t_lr = adamw.cosine_schedule(3e-4, warmup=5, total=40)
    for step in range(0, 45):
        np.testing.assert_allclose(float(t_lr(step)), float(r_lr(step)),
                                   rtol=1e-6, atol=1e-12)
    assert float(t_lr(0)) == 0.0
    assert float(t_lr(torch.tensor(5, dtype=torch.int32))) == \
        pytest.approx(3e-4)


def test_compression_round_trip_and_error_feedback():
    """Against the reference's `compress_tree`, twice (residuals carried);
    each leaf's error is within half a quantization step and the residual
    is exactly what the int8 pass dropped."""
    rng = np.random.default_rng(8)
    grads = [_tree(rng), _tree(rng)]
    r_res = r_comp.init_residuals(jax.tree.map(jnp.asarray, grads[0]))
    t_res = compression.init_residuals(tree.tree_map(torch.from_numpy,
                                                      grads[0]))
    for g in grads:
        tg = tree.tree_map(torch.from_numpy, g)
        prev = [r.clone() for r in tree.leaves(t_res)]
        rdq, r_res = r_comp.compress_tree(jax.tree.map(jnp.asarray, g), r_res)
        tdq, t_res = compression.compress_tree(tg, t_res)
        for a, b in zip(tree.leaves(tdq), jax.tree.leaves(rdq)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)
        for a, b in zip(tree.leaves(t_res), jax.tree.leaves(r_res)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)
        for gl, r0, dq, r1 in zip(tree.leaves(tg), prev, tree.leaves(tdq),
                                  tree.leaves(t_res)):
            full = gl + r0
            step = full.abs().max() / 127.0
            assert float((full - dq).abs().max()) <= float(step) / 2 + 1e-7
            torch.testing.assert_close(r1, full - dq, atol=0, rtol=0)
    q, scale, res = compression.compress(torch.zeros(4), torch.zeros(4))
    assert q.dtype == torch.int8 and not q.any() and float(scale) == 0.0
    assert not res.any()


@pytest.mark.parametrize("step,seed", [(0, 0), (17, 3), (123456, 42),
                                       (2 ** 33 + 5, 7)])
def test_synthetic_batch_bit_exact(step, seed):
    cfg = dict(seed=seed, vocab_size=1000, batch=4, seq_len=32)
    got = synthetic_batch(step, DataConfig(**cfg))
    want = r_synthetic_batch(step, RDataConfig(**cfg))
    for k in ("tokens", "targets"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["targets"][:, :-1])


@pytest.mark.parametrize("micro", [1, 2])
def test_three_train_steps_match_reference(ref_params, micro):
    """`make_train_step` against the reference's jitted train step from the
    same weights and batches, parameters compared after every step. Adam's
    early steps are about lr sign(g): an element whose gradient lies within
    float32 summation noise of 0 may step either way, and the reference's
    CE gradient carries +1 at each row's argmax (ROADMAP C), which a near
    tie flips. So every element lies within 2 lr per step of the
    reference's, and all but 1e-3 of them within 1e-6."""
    ropt, topt = RAdamWConfig(lr=1e-3), AdamWConfig(lr=1e-3)
    rmodel = r_build(R_G)
    rstate = r_init_state(rmodel, jax.random.PRNGKey(0), ropt)
    rstep = jax.jit(r_make_train_step(rmodel, ropt, microbatches=micro))
    tm = _tmodel(ref_params)
    tstate = init_state(tm, topt)
    tstep = make_train_step(tm, topt, microbatches=micro)
    dcfg = dict(vocab_size=R_G.vocab_size, batch=4, seq_len=16)
    for s in range(3):
        b = r_synthetic_batch(s, RDataConfig(**dcfg))
        rstate, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tmet = tstep(tstate, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(rm[k]),
                                       **LOSS_TOL)
        assert int(tstate["step"]) == int(rstate["step"]) == s + 1
        want = _grads_like_port(jax.tree.map(np.asarray, rstate["params"]))
        got = torch.cat([p.detach().flatten()
                         for p in tree.leaves(tstate["params"])])
        diff = (got - torch.cat([w.flatten() for w in want])).abs()
        assert float(diff.max()) <= 2 * topt.lr * (s + 1)
        assert int((diff > 1e-6).sum()) <= 1e-3 * diff.numel(), \
            int((diff > 1e-6).sum())


def test_eval_step_is_the_loss_without_gradients(ref_params):
    tm = _tmodel(ref_params)
    batch = {k: torch.from_numpy(v) for k, v in _batch(3, 2, 16).items()}
    for p in tm.parameters():
        p.requires_grad_(True)
    out = make_eval_step(tm)(batch)
    loss, _ = tm.loss(batch)
    assert not out["loss"].requires_grad
    assert float(out["loss"]) == float(loss.detach())
    assert set(out) == {"loss", "ce", "aux"}


# ---------------------------------------------------------------------------
# checkpoints and the supervisor (tests/test_runtime.py on the port)
# ---------------------------------------------------------------------------


def _setup(tmp_path, compress=False, state_dtype="float32"):
    model = build(T_G, device="cpu", seed=0)
    opt = AdamWConfig(lr=1e-3, state_dtype=state_dtype)
    state = init_state(model, opt, compress_grads=compress)
    step = make_train_step(model, opt, compress_grads=compress)
    dcfg = DataConfig(vocab_size=T_G.vocab_size, batch=2, seq_len=16)

    def mb(s):
        return {k: torch.from_numpy(v)
                for k, v in synthetic_batch(s, dcfg).items()}

    return model, state, step, mb, CheckpointManager(str(tmp_path), keep=3)


def _leaves(state):
    return [t.detach().clone() for t in tree.leaves(state)]


@pytest.mark.parametrize("compress,state_dtype", [
    (False, "float32"), (True, "bfloat16")])
def test_checkpoint_roundtrip(tmp_path, compress, state_dtype):
    _, state, step, mb, ckpt = _setup(tmp_path, compress, state_dtype)
    state, _ = step(state, mb(0))
    ckpt.save(1, state, blocking=True)
    assert ckpt.latest_step() == 1
    d = tmp_path / "step_000000001"
    assert (d / "manifest.json").is_file() and (d / "host_0.npz").is_file()
    target = tree.tree_map(torch.zeros_like, state)
    restored = ckpt.restore(1, target)
    assert restored is target
    for a, b in zip(tree.leaves(state), tree.leaves(restored)):
        assert a.dtype == b.dtype and a.device == b.device
        torch.testing.assert_close(a.detach(), b, atol=0, rtol=0)


def test_checkpoint_async_and_gc(tmp_path):
    _, state, step, mb, ckpt = _setup(tmp_path)
    for s in range(1, 6):
        ckpt.save(s, state, blocking=False)
    ckpt.wait()
    assert ckpt.latest_step() == 5
    assert ckpt.all_steps() == [3, 4, 5]          # keep=3


def test_async_save_holds_the_values_at_save_time(tmp_path):
    """The host copy is taken on the caller's thread: updating the state in
    place right after `save` does not reach the checkpoint."""
    _, state, step, mb, ckpt = _setup(tmp_path)
    before = _leaves(state)
    ckpt.save(1, state, blocking=False)
    state, _ = step(state, mb(0))
    ckpt.wait()
    restored = ckpt.restore(1, tree.tree_map(torch.zeros_like, state))
    for a, b in zip(before, tree.leaves(restored)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_supervisor_recovers_from_injected_failure(tmp_path):
    """Dies at step 4 (after the checkpoint at 2); the supervisor restores
    and resumes, and the result equals an uninterrupted run bit for bit."""
    _, ref_state, ref_step, mb, _ = _setup(tmp_path / "r")
    for s in range(6):
        ref_state, _ = ref_step(ref_state, mb(s))

    _, state0, step, _, _ = _setup(tmp_path / "x")
    fails = {"left": 1}

    def fault_hook(step_num):
        if step_num == 4 and fails["left"]:
            fails["left"] -= 1
            raise SimulatedHostFailure("node lost")

    sup = Supervisor(step, mb, CheckpointManager(str(tmp_path / "f"), keep=3),
                     SupervisorConfig(ckpt_every=2), fault_hook=fault_hook)
    state, _ = sup.run(state0, 6)
    assert len(sup.events) == 1 and sup.events[0]["step"] == 4
    assert int(state["step"]) == 6
    for a, b in zip(_leaves(ref_state), _leaves(state)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_supervisor_nan_sentinel(tmp_path):
    _, state0, real, mb, _ = _setup(tmp_path)
    calls = {"n": 0}

    def poisoned_step(state, batch):
        calls["n"] += 1
        new_state, m = real(state, batch)
        if calls["n"] == 3:   # poison exactly one step
            m = dict(m, loss=torch.tensor(float("nan")))
        return new_state, m

    sup = Supervisor(poisoned_step, mb,
                     CheckpointManager(str(tmp_path / "nan"), keep=2),
                     SupervisorConfig(ckpt_every=1))
    state, metrics = sup.run(state0, 5)
    assert len(sup.events) == 1 and "non-finite" in sup.events[0]["error"]
    assert np.isfinite(float(metrics["loss"]))
    assert int(state["step"]) == 5


def test_straggler_detector_flags_slow_host():
    det = StragglerDetector(4, SupervisorConfig(straggler_factor=2.0,
                                                ewma_alpha=1.0))
    assert det.update(np.array([0.1, 0.1, 0.1, 0.5])) == [3]
    assert det.update(np.array([0.1, 0.1, 0.1, 0.1])) == []  # recovered


def test_train_cli_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--preset",
         "reduced", "--device", "cpu", "--steps", "3", "--ckpt-dir",
         str(tmp_path)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert sum(line.startswith("step ") for line in lines) == 3
    assert any(line.startswith("done: 3 steps") and "0 flash launches" in line
               for line in lines), out.stdout


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-125m"])
def test_train_mode_on_unported_layers_raises(arch):
    """The hybrid's and xLSTM's layer kinds (rec, local, mlstm, slstm),
    which once raised in train mode, now train: a finite loss, and a
    finite, non-zero gradient for every parameter that reaches the loss
    (tests/test_torch_models.py holds the values to the reference)."""
    model = build(t_get_config(arch).reduced(), device="cpu", seed=0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(4, 1, 8).items()}
    for p in model.parameters():
        p.requires_grad_(True)
    loss, parts = model.loss(batch)
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    assert float(parts["aux"]) == 0.0
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), \
            name
        assert float(p.grad.abs().max()) > 0, name


def test_every_weight_gets_a_gradient_in_bfloat16():
    """With a bfloat16 compute cast the train path casts afresh on every
    call: every weight of rank >= 2 (and every norm scale) gets a non-zero
    gradient, also after a prefill has filled the memoized, detached casts
    of the serve path."""
    cfg = dataclasses.replace(T_G, dtype="bfloat16")
    model = build(cfg, device="cpu", seed=0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(5, 2, 16).items()}
    model.prefill({"tokens": batch["tokens"]}, max_len=20)
    assert model._cast_cache
    grads = _grads(model, batch)
    names = [n for n, _ in model.named_parameters()]
    assert len(grads) == len(names)
    for g in grads:
        assert g is not None and bool(g.abs().sum() > 0)
    assert sum(g.dim() >= 2 for g in grads) == 2 * 7 + 1
