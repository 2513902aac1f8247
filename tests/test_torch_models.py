"""Port vs reference: every non-MoE config of the registry as a reduced
model (the MoE pair is in tests/test_torch_moe.py): forward logits and
aux, prefill then decode, and one train step's loss and gradients, from
the reference's init carried over with `params_from_jax`.

The dense configs (llama3.2-1b, qwen3-14b with qk-norm, granite-3-8b,
gemma-2b) take tokens; the embed-stub ones (musicgen-large with its plain
GELU MLP, internvl2-26b) take seeded pseudo-embeddings; the hybrid
(RG-LRU and sliding-window layers) and xLSTM (mLSTM and sLSTM cells)
stacks take tokens too, and their train step is also held at 64 and 512
positions, where the mLSTM takes its chunkwise form (one chunk, then two
checkpointed chunks of 256). Reference calls run under `jax.jit`; the
tolerance is the reference's teacher-forcing 2e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import build as r_build
from repro_torch import tree
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_jax
from repro_torch.models.model import Model

TOL = dict(atol=2e-4, rtol=2e-4)
TRAINED = ("llama3.2-1b", "qwen3-14b", "granite-3-8b", "gemma-2b",
           "musicgen-large", "internvl2-26b", "recurrentgemma-9b",
           "xlstm-125m")
RECURRENT = ("recurrentgemma-9b", "xlstm-125m")


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """Deterministic float32 sums on one intra-op thread (see
    tests/test_torch_rglru.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=TRAINED)
def arch_model(request):
    arch = request.param
    rcfg, tcfg = r_get_config(arch).reduced(), t_get_config(arch).reduced()
    rmodel = r_build(rcfg)
    np_params = jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(0)))
    tmodel = Model(tcfg, params=params_from_jax(np_params, tcfg,
                                                device="cpu"))
    return arch, rcfg, rmodel, np_params, tmodel


def _inputs(cfg, b, s, seed):
    """(reference inputs, port inputs) of tokens or embeds, and targets."""
    rng = np.random.default_rng(seed)
    if cfg.embed_stub:
        x = {"embeds": (rng.standard_normal((b, s, cfg.d_model))
                        .astype(np.float32) * 0.02)}
    else:
        x = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))
             .astype(np.int32)}
    x["targets"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return x


def _r(x):
    return {k: jnp.asarray(v) for k, v in x.items()}


def _t(x):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in x.items()}


def _cut(x, a, b):
    return {k: v[:, a:b] for k, v in x.items() if k != "targets"}


def test_forward_logits_and_aux_match_reference(arch_model):
    arch, cfg, rmodel, np_params, tmodel = arch_model
    x = _inputs(cfg, 2, 16, 1)
    inp = {k: v for k, v in x.items() if k != "targets"}
    rlog, raux = jax.jit(rmodel.forward)(jax.tree.map(jnp.asarray, np_params),
                                         _r(inp))
    tlog, taux = tmodel(_t(inp))
    assert tlog.shape == (2, 16, cfg.vocab_padded)
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(rlog), **TOL)
    assert float(taux) == float(raux) == 0.0


def test_prefill_then_decode_match_reference(arch_model):
    """Prefill 9 positions, then 3 decode steps fed the next positions."""
    arch, cfg, rmodel, np_params, tmodel = arch_model
    rparams = jax.tree.map(jnp.asarray, np_params)
    x = _inputs(cfg, 2, 12, 2)
    prefill = jax.jit(rmodel.prefill, static_argnums=2)
    decode = jax.jit(rmodel.decode_step)
    rc, rlog = prefill(rparams, _r(_cut(x, 0, 9)), 12)
    tc, tlog = tmodel.prefill(_t(_cut(x, 0, 9)), max_len=12)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), **TOL)
    for t in range(9, 12):
        step = _cut(x, t, t + 1)
        step["positions"] = np.full((2,), t, np.int32)
        rc, rlog = decode(rparams, rc, _r(step))
        tstep = _t(_cut(x, t, t + 1))
        tstep["positions"] = torch.full((2,), t, dtype=torch.int32)
        tc, tlog = tmodel.decode_step(tc, tstep)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), **TOL)


def test_train_step_loss_and_gradients_match_reference(arch_model):
    """`Model.loss` and every parameter's gradient against
    `jax.value_and_grad(model.loss)` on one batch of 2 x 16."""
    _check_train_step(arch_model, _inputs(arch_model[1], 2, 16, 3))


@pytest.mark.parametrize("seq", [64, 512])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_train_step_at_longer_sequences(arch, seq):
    """The hybrid and xLSTM train step on one batch of 1 x `seq`: at 64
    positions the mLSTM takes its chunkwise form in one chunk, at 512 in
    two checkpointed chunks; the RG-LRU and sLSTM scans run `seq` steps."""
    rcfg, tcfg = r_get_config(arch).reduced(), t_get_config(arch).reduced()
    rmodel = r_build(rcfg)
    np_params = jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(1)))
    tmodel = Model(tcfg, params=params_from_jax(np_params, tcfg,
                                                device="cpu"))
    _check_train_step((arch, rcfg, rmodel, np_params, tmodel),
                      _inputs(rcfg, 1, seq, 4))


def _check_train_step(arch_model, batch):
    arch, cfg, rmodel, np_params, tmodel = arch_model
    (rl, rparts), rg = jax.jit(jax.value_and_grad(rmodel.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, np_params), _r(batch))
    for p in tmodel.parameters():
        p.requires_grad_(True)
        p.grad = None
    loss, parts = tmodel.loss(_t(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(rl), **TOL)
    np.testing.assert_allclose(float(parts["ce"].detach()),
                               float(rparts["ce"]), **TOL)
    want = tree.leaves(params_from_jax(jax.tree.map(np.asarray, rg), cfg,
                                       device="cpu"))
    got = tree.leaves(tmodel.params())
    assert len(got) == len(want)
    for p, g in zip(got, want):
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), **TOL)
    for p in tmodel.parameters():
        p.requires_grad_(False)
        p.grad = None
