"""Port vs reference: DeepSeek-V2 multi-head latent attention
(`models/attention.py`: `mla_init`, `_mla_project`, the absorbed
`_mla_attend`, the explicit `_mla_attend_blockwise`, `mla_apply`,
`mla_make_cache`, `mla_prefill`, `mla_decode`) on reduced
deepseek-v2-lite-16b's shapes (d_model 64, 4 heads, kv_lora_rank 32,
nope 16 + rope 8, v 16).

Weights are the reference's `mla_init`, inputs numpy seeds; reference
calls run under `jax.jit`. Below 1024 tokens both take the absorbed form,
from 1024 the explicit blockwise one. Outputs, caches and gradients at
1e-5 (float32 sums in other orders); weight gradients over 1024 tokens at
1e-4 relative (see `test_mla_apply_gradients_match_reference`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import attention as rattn
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import attention as tattn

TOL = dict(atol=1e-5, rtol=1e-5)
R_DS = r_get_config("deepseek-v2-lite-16b").reduced()
T_DS = t_get_config("deepseek-v2-lite-16b").reduced()


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """Deterministic float32 sums on one intra-op thread (see
    tests/test_torch_rglru.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed=0):
    p = jax.tree.map(np.asarray,
                     rattn.mla_init(jax.random.PRNGKey(seed), R_DS,
                                    jnp.float32))

    def t(tree):
        if isinstance(tree, dict):
            return {k: t(v) for k, v in tree.items()}
        return torch.from_numpy(np.array(tree))
    return p, t(p)


def _x(b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, R_DS.d_model)).astype(np.float32)


def _pos(b, s):
    return np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()


def test_mla_init_shapes_match_reference():
    p, _ = _params()
    gen = torch.Generator().manual_seed(0)
    tp = tattn.mla_init(gen, T_DS, torch.float32, "cpu")
    flat = jax.tree_util.tree_flatten_with_path(p)[0]
    for path, leaf in flat:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path


@pytest.mark.parametrize("t", [1, 16, 200, 1024])
def test_mla_prefill_matches_reference(t):
    """`mla_prefill` over t tokens (1024: the explicit blockwise form):
    the output and both latent caches."""
    p, tp = _params(1)
    x, pos = _x(2, t, t), _pos(2, t)
    ry, rc = jax.jit(lambda p_, x_, q_: rattn.mla_prefill(p_, R_DS, x_, q_,
                                                         t + 4))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(pos))
    ty, tc = tattn.mla_prefill(tp, T_DS, torch.from_numpy(x),
                               torch.from_numpy(pos), t + 4)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), **TOL)
    for k in ("c_kv", "k_rope"):
        assert tuple(tc[k].shape) == rc[k].shape
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(rc[k]), **TOL)


def test_mla_absorbed_and_explicit_forms_agree():
    """The two attention forms compute one function: the absorbed form the
    short paths take and the explicit blockwise one long sequences take,
    on the same projections (port only; each is held to the reference's
    form above)."""
    _, tp = _params(2)
    x = torch.from_numpy(_x(2, 40, 3))
    pos = torch.from_numpy(_pos(2, 40))
    q_nope, q_rope, c_kv, k_rope = tattn._mla_project(tp, T_DS, x, pos)
    mask = tattn._causal_mask(40, 40)
    a = tattn._mla_attend(tp, T_DS, q_nope, q_rope, c_kv, k_rope, mask)
    b = tattn._mla_attend_blockwise(tp, T_DS, q_nope, q_rope, c_kv, k_rope)
    np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL)


def test_mla_prefill_then_decode_matches_reference():
    """Prefill 9 tokens into a 14-token cache, then 4 decode steps at
    different positions per row: outputs and caches every step."""
    p, tp = _params(4)
    rp = jax.tree.map(jnp.asarray, p)
    x = _x(2, 13, 5)
    ry, rc = jax.jit(lambda p_, x_, q_: rattn.mla_prefill(p_, R_DS, x_, q_,
                                                         14))(
        rp, jnp.asarray(x[:, :9]), jnp.asarray(_pos(2, 9)))
    ty, tc = tattn.mla_prefill(tp, T_DS, torch.from_numpy(x[:, :9]),
                               torch.from_numpy(_pos(2, 9)), 14)
    decode = jax.jit(lambda p_, x_, c_, q_: rattn.mla_decode(p_, R_DS, x_, c_,
                                                            q_))
    for t in range(9, 13):
        positions = np.array([t, t - 2], np.int32)
        ry, rc = decode(rp, jnp.asarray(x[:, t:t + 1]), rc,
                        jnp.asarray(positions))
        ty, tc = tattn.mla_decode(tp, T_DS, torch.from_numpy(x[:, t:t + 1]),
                                  tc, torch.from_numpy(positions))
        np.testing.assert_allclose(ty.numpy(), np.asarray(ry), **TOL)
        for k in ("c_kv", "k_rope"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(rc[k]),
                                       **TOL)


@pytest.mark.parametrize("t", [16, 1024])
def test_mla_apply_gradients_match_reference(t):
    """The train path's `mla_apply`: gradients of sum(y^2) with respect to
    every weight and the input (1024: through the blockwise backward)."""
    p, _ = _params(6)
    x, pos = _x(1, t, 7), _pos(1, t)

    def r_loss(p_, x_):
        y = rattn.mla_apply(p_, R_DS, x_, jnp.asarray(pos))
        return jnp.sum(y * y)

    rgp, rgx = jax.jit(jax.grad(r_loss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))

    def leaf(v):
        return torch.from_numpy(np.array(v)).requires_grad_(True)

    tp = {k: ({kk: leaf(vv) for kk, vv in v.items()} if isinstance(v, dict)
              else leaf(v)) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y = tattn.mla_apply(tp, T_DS, tx, torch.from_numpy(pos))
    torch.sum(y * y).backward()

    def close(got, want):
        """1e-5 at 16 tokens; at 1024 each weight gradient sums 1024
        float32 terms in another order, so the bound is the train tests'
        (tests/test_torch_train.py GRAD_TOL: 1e-4 relative) with the
        absolute part 1e-6 of the leaf's largest gradient."""
        want = np.asarray(want)
        tol = TOL if t < 1024 else dict(
            rtol=1e-4, atol=1e-6 * float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, **tol)

    close(tx.grad, rgx)
    for k, v in tp.items():
        if isinstance(v, dict):
            close(v["scale"].grad, rgp[k]["scale"])
        else:
            close(v.grad, rgp[k])
