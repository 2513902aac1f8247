"""Port vs reference: the Mixture-of-Experts layer (`models/moe.py`), the
single-card expert-parallel body (`models/moe_ep.py::_local_moe`), the
router's float32 rule, and the two MoE configs (deepseek-v2-lite-16b with
MLA and a dense layer 0, grok-1-314b) as whole reduced models.

Weights come from the reference's init (carried over with
`params_from_jax`) or from numpy seeds; reference calls run under
`jax.jit`. Routing (indices, positions within the expert, keep masks) is
held to the bit, the layer's float outputs and aux at 1e-5, whole models
at the reference's teacher-forcing tolerance 2e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import build as r_build
from repro.models import moe as rmoe
from repro_torch import tree
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.models.model import KEEP_F32, Model, build
from repro_torch.models.moe_ep import _local_moe

LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """Deterministic float32 sums on one intra-op thread (see
    tests/test_torch_rglru.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch="deepseek-v2-lite-16b", **moe):
    r, t = r_get_config(arch).reduced(), t_get_config(arch).reduced()
    if moe:
        r = dataclasses.replace(r, moe=dataclasses.replace(r.moe, **moe))
        t = dataclasses.replace(t, moe=dataclasses.replace(t.moe, **moe))
    return r, t


def _layer(rcfg, seed=0):
    p = jax.tree.map(np.asarray,
                     rmoe.moe_init(jax.random.PRNGKey(seed), rcfg,
                                   jnp.float32))
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _ref_routing(rcfg, p, xf):
    """The reference's routing intermediates, as `moe_apply` forms them."""
    m = rcfg.moe
    n = xf.shape[0]
    cap = max(int(m.capacity_factor * m.top_k * n / m.n_experts), 1)
    logits = jnp.einsum("nd,de->ne", jnp.asarray(xf), jnp.asarray(p["router"]))
    w, idx = rmoe._top_k_gating(logits, m.top_k, m.router_renorm)
    onehot = jax.nn.one_hot(idx, m.n_experts, dtype=jnp.int32)
    flat = onehot.reshape(n * m.top_k, m.n_experts)
    pos = jnp.cumsum(flat, axis=0) - flat
    pos = jnp.sum(pos.reshape(n, m.top_k, m.n_experts) * onehot, axis=-1)
    return (np.asarray(w), np.asarray(idx), np.asarray(pos),
            np.asarray(pos < cap), cap)


@pytest.mark.parametrize("arch,cf,n_tokens,drops", [
    ("deepseek-v2-lite-16b", 1.25, 64, None),
    ("deepseek-v2-lite-16b", 1.25, 7, None),
    ("deepseek-v2-lite-16b", 0.5, 64, True),
    ("deepseek-v2-lite-16b", 8.0, 64, False),
    ("grok-1-314b", 1.25, 64, None), ("grok-1-314b", 0.5, 33, True),
    ("grok-1-314b", 8.0, 33, False)])
def test_routing_equals_reference_to_the_bit(arch, cf, n_tokens, drops):
    """Top-k indices, positions within each expert and keep masks equal the
    reference's: the published capacity factor, one that drops choices
    (0.5) and one that drops none (8.0)."""
    rcfg, tcfg = _cfgs(arch, capacity_factor=cf)
    p, tp = _layer(rcfg)
    xf = _x((n_tokens, rcfg.d_model), 1)
    w, idx, pos, keep, cap = _ref_routing(rcfg, p, xf)
    logits = torch.matmul(torch.from_numpy(xf), tp["router"])
    tw, tidx = tmoe._top_k_gating(logits, tcfg.moe.top_k,
                                  tcfg.moe.router_renorm)
    onehot = torch.nn.functional.one_hot(tidx, tcfg.moe.n_experts) \
        .to(torch.int32)
    tpos, tkeep = tmoe.route(onehot, cap)
    np.testing.assert_array_equal(tidx.numpy(), idx)
    np.testing.assert_array_equal(tpos.numpy(), pos)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    np.testing.assert_allclose(tw.numpy(), w, **LAYER_TOL)
    if drops is not None:
        assert bool((~keep).any()) == drops, int((~keep).sum())


def test_top_k_puts_the_lower_index_first_on_ties():
    """`jax.lax.top_k`'s order: descending, ties by the lower index."""
    x = np.array([[0.2, 0.5, 0.5, 0.1, 0.5], [1.0, 1.0, 1.0, 1.0, 1.0],
                  [0.0, -1.0, 3.0, 3.0, -1.0]], np.float32)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 3)
    tv, ti = tmoe.top_k_desc(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


@pytest.mark.parametrize("arch,cf", [("deepseek-v2-lite-16b", 1.25),
                                     ("deepseek-v2-lite-16b", 0.5),
                                     ("deepseek-v2-lite-16b", 8.0),
                                     ("grok-1-314b", 1.25),
                                     ("grok-1-314b", 8.0)])
def test_moe_apply_output_and_aux_match_reference(arch, cf):
    """`moe_apply` on [2, 16, D]: y (shared experts included for deepseek)
    and the Switch aux loss at 1e-5."""
    rcfg, tcfg = _cfgs(arch, capacity_factor=cf)
    p, tp = _layer(rcfg, seed=3)
    x = _x((2, 16, rcfg.d_model), 4)
    ry, raux = jax.jit(lambda p_, x_: rmoe.moe_apply(p_, rcfg, x_))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    ty, taux = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), **LAYER_TOL)
    np.testing.assert_allclose(float(taux), float(raux), **LAYER_TOL)
    assert ("shared_in" in tp) == (arch == "deepseek-v2-lite-16b")


def test_moe_gradients_match_reference():
    """The backward of `moe_apply` (scatter-add, gather, experts, router
    through the gate weights and the aux loss) at 1e-5."""
    rcfg, tcfg = _cfgs()
    p, _ = _layer(rcfg, seed=5)
    x = _x((2, 12, rcfg.d_model), 6)

    def r_loss(p_, x_):
        y, aux = rmoe.moe_apply(p_, rcfg, x_)
        return jnp.sum(y * y) + aux

    rg_p, rg_x = jax.jit(jax.grad(r_loss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_apply(tp, tcfg, tx)
    (torch.sum(y * y) + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(rg_x), **LAYER_TOL)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(rg_p[k]),
                                   **LAYER_TOL)


def _ep_cfgs(cf):
    rcfg, tcfg = _cfgs("grok-1-314b", n_experts=8, top_k=2, d_ff_expert=32,
                       n_shared=0, capacity_factor=cf)
    return (dataclasses.replace(rcfg, d_model=64),
            dataclasses.replace(tcfg, d_model=64))


def _shard_partials(tp, tcfg, xf, n_shards=4):
    e_local = tcfg.moe.n_experts // n_shards
    return [_local_moe(tp["router"], *(tp[k][s * e_local:(s + 1) * e_local]
                                       for k in ("w_in", "w_gate", "w_out")),
                       xf, cfg=tcfg, e_local=e_local, shard=s)
            for s in range(n_shards)]


def test_local_moe_summed_over_shards_equals_moe_apply():
    """`_local_moe` of each of 4 emulated expert-parallel shards (2 experts
    each), summed, equals `moe_apply`'s routed output in the no-drop regime
    (the reference's tests/test_sharding.py::test_moe_ep_matches_reference
    setup and bound, without the mesh)."""
    rcfg, tcfg = _ep_cfgs(8.0)
    p, tp = _layer(rcfg)
    x = _x((4, 16, 64), 1)
    y_ref, _ = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x))
    ry, _ = rmoe.moe_apply(jax.tree.map(jnp.asarray, p), rcfg, jnp.asarray(x))
    np.testing.assert_allclose(y_ref.numpy(), np.asarray(ry), **LAYER_TOL)
    parts = _shard_partials(tp, tcfg, torch.from_numpy(x).reshape(-1, 64))
    err = float((sum(parts).reshape(x.shape) - y_ref).abs().max())
    assert err < 2e-5, err


@pytest.mark.parametrize("cf", [8.0, 0.25])
def test_local_moe_equals_reference_body_over_shards(cf):
    """The port's partials, summed, against the reference's `_local_moe`
    itself, its shard axis emulated by `jax.vmap(axis_name=...)` (which
    gives `axis_index` and `psum` their meaning without a mesh). At
    capacity factor 0.25 experts overflow: a choice's position counts the
    earlier choices of its own expert, which all live on one shard, so the
    shards drop what `moe_apply` drops and the sum still equals it (drops
    differ only once tokens are split over data shards, as the reference's
    `moe_apply_ep` notes)."""
    from repro.models.moe_ep import _local_moe as r_local_moe

    rcfg, tcfg = _ep_cfgs(cf)
    p, tp = _layer(rcfg, seed=2)
    xf = _x((64, 64), 3)

    def split(a):
        return jnp.asarray(a).reshape((4, 2) + a.shape[1:])

    body = jax.vmap(
        lambda r, wi, wg, wo, x_: r_local_moe(r, wi, wg, wo, x_, cfg=rcfg,
                                              e_local=2, axis="model"),
        in_axes=(None, 0, 0, 0, None), axis_name="model")
    ry = body(jnp.asarray(p["router"]), split(p["w_in"]), split(p["w_gate"]),
              split(p["w_out"]), jnp.asarray(xf))
    got = sum(_shard_partials(tp, tcfg, torch.from_numpy(xf)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ry[0]), **LAYER_TOL)
    full, _ = tmoe.moe_apply(tp, tcfg, torch.from_numpy(xf)[None])
    assert float((got - full[0]).abs().max()) < 2e-5
    _, _, _, keep, _ = _ref_routing(rcfg, p, xf)
    assert bool((~keep).any()) == (cf < 1.0)


# ---------------------------------------------------------------------------
# the router's float32 rule
# ---------------------------------------------------------------------------


def test_compute_cast_keeps_the_router_float32():
    """With a bfloat16 compute dtype the serve and train casts convert every
    float32 weight of rank >= 2 except `router` (the reference's
    `_KEEP_F32`), and a serving model holds it in float32 too."""
    cfg = dataclasses.replace(t_get_config("deepseek-v2-lite-16b").reduced(),
                              dtype="bfloat16")
    assert KEEP_F32 == ("router",)
    model = build(cfg, device="cpu", seed=0)
    moe_layer = model.layers[1]
    for train in (False, True):
        p = model._layer_params(moe_layer, train=train)
        assert p["mlp"]["router"].dtype == torch.float32
        assert p["mlp"]["router"] is moe_layer.mlp["router"]
        for k in ("w_in", "w_gate", "w_out", "shared_in"):
            assert p["mlp"][k].dtype == torch.bfloat16, k
        assert p["attn"]["w_uk"].dtype == torch.bfloat16
        assert p["ln1"]["scale"].dtype == torch.float32
    served = build(cfg, device="cpu", seed=0, for_serving=True)
    assert served.layers[1].mlp["router"].dtype == torch.float32
    assert served.layers[1].mlp["w_in"].dtype == torch.bfloat16
    torch.testing.assert_close(served.layers[1].mlp["router"],
                               moe_layer.mlp["router"], atol=0, rtol=0)


def test_bf16_router_would_route_differently():
    """The fault the router rule repairs: before it, `Model._cast` and
    `_train_cast` cast the router to bfloat16 with every other weight.
    On reduced deepseek's first MoE layer in bfloat16 (seeded input, 4096
    tokens) the float32 router picks the reference's experts to the bit,
    while a bfloat16 router moves the routing logits and flips choices."""
    rcfg = dataclasses.replace(r_get_config("deepseek-v2-lite-16b").reduced(),
                               dtype="bfloat16")
    p, tp = _layer(rcfg, seed=7)
    x = torch.from_numpy(_x((4096, rcfg.d_model), 8)).to(torch.bfloat16)
    _, ridx, _, _, _ = _ref_routing(
        rcfg, p, np.asarray(jnp.asarray(x.float().numpy())
                            .astype(jnp.bfloat16).astype(jnp.float32)))
    f32 = torch.matmul(x.float(), tp["router"])
    b16 = torch.matmul(x.float(), tp["router"].to(torch.bfloat16).float())
    _, idx32 = tmoe._top_k_gating(f32, 2, True)
    _, idx16 = tmoe._top_k_gating(b16, 2, True)
    np.testing.assert_array_equal(idx32.numpy(), ridx)
    flipped = int((idx16 != idx32).any(-1).sum())
    assert flipped > 0
    assert 1e-3 < float((b16 - f32).abs().max()) < 1e-1


# ---------------------------------------------------------------------------
# the MoE configs as whole reduced models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["deepseek-v2-lite-16b",
                                        "grok-1-314b"])
def moe_model(request):
    arch = request.param
    rcfg, tcfg = r_get_config(arch).reduced(), t_get_config(arch).reduced()
    rmodel = r_build(rcfg)
    np_params = jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(0)))
    return arch, rcfg, tcfg, rmodel, np_params


def _tmodel(np_params, cfg):
    return Model(cfg, params=params_from_jax(np_params, cfg, device="cpu"))


def test_params_from_jax_carries_moe_and_mla_leaves(moe_model):
    arch, rcfg, tcfg, _, np_params = moe_model
    tm = _tmodel(np_params, tcfg)
    fd = rcfg.first_dense_layers
    assert len(tm.layers) == rcfg.n_layers
    for li, layer in enumerate(tm.layers):
        mlp = layer.mlp
        if li < fd:
            src = np_params["first_dense"][li]
            assert set(mlp.keys()) == {"w_in", "w_gate", "w_out"}
            assert mlp["w_in"].shape[1] == rcfg.d_ff_first_dense
        else:
            src = jax.tree.map(lambda a: a[li - fd], np_params["groups"][0])
            keys = {"router", "w_in", "w_gate", "w_out"}
            if rcfg.moe.n_shared:
                keys |= {"shared_in", "shared_gate", "shared_out"}
            assert set(mlp.keys()) == keys
        for k in mlp.keys():
            np.testing.assert_array_equal(mlp[k].detach().numpy(),
                                          src["mlp"][k])
        if rcfg.mla is not None:
            assert set(layer.attn.names) == {"wq", "w_kv_a", "kv_a_norm",
                                             "w_uk", "w_uv", "wo"}
            np.testing.assert_array_equal(
                layer.attn.kv_a_norm["scale"].detach().numpy(),
                src["attn"]["kv_a_norm"]["scale"])


def test_moe_model_forward_and_aux_match_reference(moe_model):
    arch, rcfg, tcfg, rmodel, np_params = moe_model
    toks = np.random.default_rng(2).integers(0, 256, (2, 16)).astype(np.int32)
    rlog, raux = jax.jit(rmodel.forward)(jax.tree.map(jnp.asarray, np_params),
                                         {"tokens": jnp.asarray(toks)})
    tlog, taux = _tmodel(np_params, tcfg)({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(rlog),
                               **MODEL_TOL)
    np.testing.assert_allclose(float(taux), float(raux), **MODEL_TOL)
    assert float(taux) > 0


def test_moe_model_prefill_then_decode_match_reference(moe_model):
    arch, rcfg, tcfg, rmodel, np_params = moe_model
    rparams = jax.tree.map(jnp.asarray, np_params)
    toks = np.random.default_rng(3).integers(0, 256, (2, 12)).astype(np.int32)
    prefill = jax.jit(rmodel.prefill, static_argnums=2)
    decode = jax.jit(rmodel.decode_step)
    tm = _tmodel(np_params, tcfg)
    rc, rlog = prefill(rparams, {"tokens": jnp.asarray(toks[:, :9])}, 12)
    tc, tlog = tm.prefill({"tokens": torch.from_numpy(toks[:, :9]).long()},
                          max_len=12)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), **MODEL_TOL)
    for t in range(9, 12):
        rc, rlog = decode(rparams, rc, {
            "tokens": jnp.asarray(toks[:, t:t + 1]),
            "positions": jnp.full((2,), t, jnp.int32)})
        tc, tlog = tm.decode_step(tc, {
            "tokens": torch.from_numpy(toks[:, t:t + 1]).long(),
            "positions": torch.full((2,), t, dtype=torch.int32)})
        np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog),
                                   **MODEL_TOL)


def test_moe_model_train_loss_and_gradients_match_reference(moe_model):
    """One train step's loss (ce + 0.01 aux) and every gradient, router
    included, against `jax.value_and_grad(model.loss)`."""
    arch, rcfg, tcfg, rmodel, np_params = moe_model
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, 256, (2, 16)).astype(np.int32),
             "targets": rng.integers(0, 256, (2, 16)).astype(np.int32)}
    (rl, rparts), rg = jax.jit(jax.value_and_grad(rmodel.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, np_params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tm = _tmodel(np_params, tcfg)
    for p in tm.parameters():
        p.requires_grad_(True)
    loss, parts = tm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    for got, want in ((loss, rl), (parts["ce"], rparts["ce"]),
                      (parts["aux"], rparts["aux"])):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   **MODEL_TOL)
    want = tree.leaves(params_from_jax(jax.tree.map(np.asarray, rg), tcfg,
                                       device="cpu"))
    got = tree.leaves(tm.params())
    assert len(got) == len(want)
    for p, g in zip(got, want):
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), **MODEL_TOL)


@pytest.mark.parametrize("micro", [1, 2])
def test_moe_train_step_averages_aux_as_the_reference(moe_model, micro):
    """One `make_train_step` against the reference's jitted train step in
    1 and 2 microbatches: loss, ce, the nonzero aux and the grad norm are
    the microbatches' mean, as the reference's accumulation scan takes
    them, and every parameter moves as the reference's does (within 2 lr,
    all but 1e-3 of them within 1e-6: the bound of
    tests/test_torch_train.py::test_three_train_steps_match_reference)."""
    from repro.data import DataConfig as RDataConfig
    from repro.data import synthetic_batch as r_synthetic_batch
    from repro.optim import AdamWConfig as RAdamWConfig
    from repro.train import init_state as r_init_state
    from repro.train import make_train_step as r_make_train_step
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_state, make_train_step

    arch, rcfg, tcfg, rmodel, np_params = moe_model
    ropt, topt = RAdamWConfig(lr=1e-3), AdamWConfig(lr=1e-3)
    rstate = r_init_state(rmodel, jax.random.PRNGKey(0), ropt)
    tm = _tmodel(jax.tree.map(np.asarray, rstate["params"]), tcfg)
    rstep = jax.jit(r_make_train_step(rmodel, ropt, microbatches=micro))
    tstate = init_state(tm, topt)
    tstep = make_train_step(tm, topt, microbatches=micro)
    b = r_synthetic_batch(0, RDataConfig(vocab_size=rcfg.vocab_size, batch=4,
                                         seq_len=16))
    rstate, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in b.items()})
    tstate, tmet = tstep(tstate, {k: torch.from_numpy(v)
                                  for k, v in b.items()})
    assert float(rm["aux"]) > 0
    for k in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(float(tmet[k]), float(rm[k]), **LAYER_TOL)
    want = torch.cat([w.flatten() for w in tree.leaves(params_from_jax(
        jax.tree.map(np.asarray, rstate["params"]), tcfg, device="cpu"))])
    got = torch.cat([p.detach().flatten()
                     for p in tree.leaves(tstate["params"])])
    diff = (got - want).abs()
    assert float(diff.max()) <= 2 * topt.lr
    assert int((diff > 1e-6).sum()) <= 1e-3 * diff.numel()
