"""Port vs reference: the sharding rules, the meshes, elastic restore and
the mesh paths (`sharding/`, `launch/mesh.py`, `runtime/elastic.py`,
`cim/dispatch.py`'s mesh path, `models/moe_ep.py`, the sharded train step).

Specs: `param_specs`, `cache_specs` and `batch_specs` equal the reference's
leaf for leaf on 16x16, 2x16x16, 4x2 and 1x1 structure-only meshes for all
ten configs, matched through `convert.params_from_jax`'s unstacking: a
reference leaf stacked under `groups` carries a leading `None`, and each of
the port's per-layer leaves equals the rest. Then the reference's own
cases (divisibility, big-tensor coverage, the elastic planner).

Multi-rank cases run 8 `gloo` ranks in a child process
(`tests/_torch_gloo_ranks.py`), fed the reference's numbers: sharded
train steps, tensor-parallel over "model", of reduced llama3.2-1b,
deepseek-v2-lite-16b, gemma-2b, recurrentgemma-9b and grok-1-314b on 4x2
and of llama3.2-1b and deepseek on 1x8 against the reference's
single-device `make_train_step` (its own 8-device case fails with a
`ShardingTypeError` under JAX 0.9), a sharded prefill and 4 decode steps
of llama3.2-1b, deepseek and recurrentgemma-9b on 4x2 against its
unsharded logits, the elastic restore 4x2 -> 2x4
and 8x1 (and in place), `moe_apply_ep` on 2x4, 1x8 and 4x2, and
`execute_sharded`, `cim.multiply(mesh=)` and `lower(mesh=)` over 1, 2 and
4 "data" ranks against the reference's bits and ledgers.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.extend.core as jex
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as RP

from repro.cim import ArraySpec as RSpec
from repro.cim import PlanePack as RPack
from repro.cim import dispatch as rdisp
from repro.cim import planner as rplanner
from repro.cim.accounting import LEDGER as RLEDGER
from repro.cim.lower import lower as rlower
from repro.configs import SHAPES as RSHAPES
from repro.configs import get_config as rget
from repro.configs import input_specs as rinput_specs
from repro.data import DataConfig as RDataConfig
from repro.data import synthetic_batch as rsynthetic_batch
from repro.models import build as rbuild
from repro.models import moe as rmoe
from repro.optim import AdamWConfig as RAdamWConfig
from repro.sharding import batch_specs as rbatch_specs
from repro.sharding import cache_specs as rcache_specs
from repro.sharding import param_specs as rparam_specs
from repro.train import init_state as r_init_state
from repro.train import make_train_step as r_make_train_step
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, input_specs
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import elastic_mesh_shape
from repro_torch.models.model import build
from repro_torch.sharding import (P, batch_specs, cache_specs, param_specs,
                                  to_named)
from repro_torch.sharding import rules
from repro_torch.tree import walk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Fake:
    """A structure-only mesh (tests/test_sharding.py's)."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


MESHES = {"16x16": Fake(data=16, model=16),
          "2x16x16": Fake(pod=2, data=16, model=16),
          "4x2": Fake(data=4, model=2), "1x1": Fake(data=1, model=1)}


def _ref_leaves(tree, specs):
    paths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    sl = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, RP))
    assert len(paths) == len(sl)
    return dict(zip(paths, (tuple(s) for s in sl)))


def _port_to_ref(rmodel, port_path):
    """The reference path of a port leaf, and whether it is stacked."""
    lay = rmodel.layout
    head, rest = port_path[0], port_path[1:]
    if head != "layers":
        return "/".join(port_path), False
    i, tail = int(rest[0]), "/".join(rest[1:])
    if i < lay.n_first_dense:
        return f"first_dense/{i}/{tail}", False
    j = i - lay.n_first_dense
    period = len(lay.pattern)
    if j < lay.n_groups * period:
        return f"groups/{j % period}/{tail}", True
    return f"rem/{j - lay.n_groups * period}/{tail}", False


def _specs(tree):
    """(path, spec) of every leaf of a spec tree (a spec is a tuple)."""
    out = []
    rules.map_with_path(lambda path, s: out.append((path, s)), tree)
    return out


#: the xLSTM cells' states: the port's dict keys, the reference's tuple
#: positions (`mlstm_make_state`, `slstm_make_state`)
_MLSTM_STATE = {"C": "0", "n": "1", "m": "2"}
_SLSTM_STATE = {"h": "0", "c": "1", "n": "2", "m": "3"}


def _assert_specs_match(rmodel, rmap, tspecs):
    seen = set()
    specs = _specs(tspecs)
    for path, spec in specs:
        if path[0] == "layers" and len(path) == 3:
            keys = {p[2] for p, _ in specs if p[:2] == path[:2]}
            for order in (_MLSTM_STATE, _SLSTM_STATE):
                if keys == set(order):
                    path = path[:2] + (order[path[2]],)
        rpath, stacked = _port_to_ref(rmodel, path)
        want = rmap[rpath]
        if stacked:
            assert want[0] is None, (rpath, want)
            want = want[1:]
        assert tuple(spec) == want, (path, tuple(spec), want)
        seen.add(rpath)
    assert seen == set(rmap), sorted(set(rmap) - seen)[:5]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch):
    cfg, rcfg = get_config(arch), rget(arch)
    rmodel = rbuild(rcfg)
    rparams = jax.eval_shape(rmodel.init, jax.random.PRNGKey(0))
    tparams = build(cfg, device="meta").params()
    for name, mesh in MESHES.items():
        rmap = _ref_leaves(rparams, rparam_specs(rcfg, rparams, mesh))
        _assert_specs_match(rmodel, rmap, param_specs(cfg, tparams, mesh))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_match_reference(arch):
    cfg, rcfg = get_config(arch), rget(arch)
    rmodel = rbuild(rcfg)
    rcaches = jax.eval_shape(lambda: rmodel.init_caches(32, 64))
    tcaches = build(cfg, device="meta").init_caches(32, 64)
    for mesh in MESHES.values():
        rmap = _ref_leaves(rcaches, rcache_specs(rcfg, rcaches, mesh))
        _assert_specs_match(rmodel, rmap,
                            {"layers": cache_specs(cfg, tcaches, mesh)})
        for shape in SHAPES:
            rb = rinput_specs(rcfg, RSHAPES[shape])
            tb = input_specs(cfg, SHAPES[shape])
            assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                    for k, v in tb.items()} == \
                {k: (tuple(v.shape), str(v.dtype)) for k, v in rb.items()}
            rs = rbatch_specs(rcfg, rb, mesh)
            ts = batch_specs(cfg, tb, mesh)
            assert {k: tuple(v) for k, v in ts.items()} == \
                {k: tuple(v) for k, v in rs.items()}, (arch, shape)


def test_param_specs_divisible_everywhere():
    """Every spec divides its dim by the mesh axis size, for all archs."""
    mesh = MESHES["16x16"]
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        params = build(cfg, device="meta").params()
        specs = param_specs(cfg, params, mesh)
        pl, sl = list(walk(params)), _specs(specs)
        assert len(pl) == len(sl)
        for (path, leaf), (_, spec) in zip(pl, sl):
            for dim, entry in zip(leaf.shape, tuple(spec)):
                if entry is None:
                    continue
                axes = entry if isinstance(entry, tuple) else (entry,)
                size = int(np.prod([mesh.shape[a] for a in axes]))
                assert dim % size == 0, (arch, path, leaf.shape, spec)


def test_param_sharding_covers_big_tensors():
    """No >= 1M-element weight is fully replicated on the production mesh
    (param memory at 314B depends on it)."""
    mesh = MESHES["16x16"]
    for arch in ("grok-1-314b", "qwen3-14b", "deepseek-v2-lite-16b"):
        cfg = get_config(arch)
        params = build(cfg, device="meta").params()
        specs = param_specs(cfg, params, mesh)
        for (path, leaf), (_, spec) in zip(walk(params), _specs(specs)):
            if int(np.prod(leaf.shape)) >= 1_000_000:
                assert any(e is not None for e in tuple(spec)), \
                    (arch, path, spec)


def test_elastic_mesh_planner():
    assert elastic_mesh_shape(256) == (16, 16)
    assert elastic_mesh_shape(240) == (15, 16)   # one host of 16 lost
    assert elastic_mesh_shape(192) == (12, 16)
    assert elastic_mesh_shape(8, prefer_model=16) == (1, 8)
    assert elastic_mesh_shape(7) == (1, 7)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = MESHES["2x16x16"]
    assert rules.placements(mesh, P(("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert rules.placements(mesh, P(None, "data")) == \
        (Replicate(), Shard(1), Replicate())
    assert rules.placements(mesh, P()) == (Replicate(),) * 3
    named = to_named(mesh, {"w": P("model", None)})
    assert named["w"].placements == (Replicate(), Replicate(), Shard(0))
    assert rules.batch_placements(MESHES["4x2"], 1) == (Shard(0), Shard(1))


# ---------------------------------------------------------------------------
# multi-rank cases: 8 gloo ranks in a child process
# ---------------------------------------------------------------------------


def _ledger(led) -> dict:
    d = {k: v for k, v in vars(led).items() if k != "enabled"}
    d["bank_accesses"] = {str(k): v for k, v in
                          sorted(led.bank_accesses.items())}
    d["per_device"] = {str(k): v for k, v in sorted(led.per_device().items())}
    return d


#: the reference's single-device train steps (two each, from seed 0) that
#: the 4x2 and 1x8 sharded steps are held to: (arch, key)
TRAIN_REFS = (("llama3.2-1b", "train"), ("deepseek-v2-lite-16b", "moe_train"),
              ("gemma-2b", "gemma_train"), ("recurrentgemma-9b", "rg_train"),
              ("grok-1-314b", "grok_train"))
#: the reference's unsharded prefill + decode that the 4x2 sharded one is
#: held to (the keys of their train weights)
SERVE_REFS = ("train", "moe_train", "rg_train")


def _reference_serve(rmodel, rparams, tokens):
    """Logits of a prefill of 12 positions (max_len 16) and 4 decode steps
    fed the next tokens: [5, B, V]."""
    prefill = jax.jit(rmodel.prefill, static_argnums=2)
    decode = jax.jit(rmodel.decode_step)
    caches, logits = prefill(rparams, {"tokens": jnp.asarray(tokens[:, :12])},
                             16)
    out = [np.asarray(logits)]
    for t in range(12, 16):
        caches, logits = decode(rparams, caches, {
            "tokens": jnp.asarray(tokens[:, t:t + 1]),
            "positions": jnp.full((tokens.shape[0],), t, jnp.int32)})
        out.append(np.asarray(logits))
    return np.stack(out)


def _reference_inputs(work):
    arrays, meta = {}, {}
    # the sharded train steps, and prefill + decode from the same weights
    arrays["serve_tokens"] = np.random.RandomState(4).randint(
        0, 256, (8, 16)).astype(np.int32)
    for arch, key in TRAIN_REFS:
        rcfg = rget(arch).reduced()
        rmodel = rbuild(rcfg)
        ropt = RAdamWConfig(lr=1e-3)
        rstate = r_init_state(rmodel, jax.random.PRNGKey(0), ropt)
        tparams = params_from_jax(jax.tree.map(np.asarray, rstate["params"]),
                                  get_config(arch).reduced(), device="cpu")
        for path, leaf in walk(tparams):
            arrays[key + "::" + "::".join(path)] = leaf.numpy()
        if key in SERVE_REFS:
            arrays[key + "_serve_logits"] = _reference_serve(
                rmodel, rstate["params"], arrays["serve_tokens"])
        rstep = jax.jit(r_make_train_step(rmodel, ropt))
        dcfg = RDataConfig(vocab_size=rcfg.vocab_size, batch=8, seq_len=64)
        meta[key + "_loss"], meta[key + "_grad_norm"] = [], []
        for s in range(2):
            b = rsynthetic_batch(s, dcfg)
            rstate, m = rstep(rstate,
                              {k: jnp.asarray(v) for k, v in b.items()})
            meta[key + "_loss"].append(float(m["loss"]))
            meta[key + "_grad_norm"].append(float(m["grad_norm"]))
    # expert parallelism: tests/test_sharding.py's configuration
    mcfg = rget("grok-1-314b").reduced()
    mcfg = dataclasses.replace(
        mcfg, d_model=64,
        moe=dataclasses.replace(mcfg.moe, n_experts=8, top_k=2,
                                d_ff_expert=32, n_shared=0,
                                capacity_factor=8.0))
    p = rmoe.moe_init(jax.random.PRNGKey(0), mcfg, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 64))
    y, _ = rmoe.moe_apply(p, mcfg, x)
    for k, v in p.items():
        arrays["moe::" + k] = np.asarray(v)
    arrays["moe_x"], arrays["moe_y"] = np.asarray(x), np.asarray(y)
    # tiled accesses: tests/test_cim_array.py's sharded case
    rng = np.random.RandomState(0)
    a = rng.randint(-100, 100, 320).astype(np.int32)
    b = rng.randint(-100, 100, 320).astype(np.int32)
    spec = RSpec(banks=2, subarrays=1, rows=64, bitline_words=32)
    pa, pb = RPack.pack(jnp.asarray(a), 8), RPack.pack(jnp.asarray(b), 8)
    RLEDGER.reset()
    out = rdisp.execute_tiled(pa, pb, ("sub", "lt"), spec=spec,
                              backend="jnp-boolean")
    arrays["tile_a"], arrays["tile_b"] = a, b
    arrays["tile_sub"] = np.asarray(out["sub"].unpack())
    arrays["tile_lt"] = np.asarray(out["lt"].unpack())
    arrays["tile_sub_planes"] = np.asarray(out["sub"].planes).view(np.int32)
    meta["tile_ledger_1"] = _ledger(RLEDGER)
    for n in (2, 4):          # the reference's one controller, n devices
        RLEDGER.reset()
        RLEDGER.charge_banked(("sub", "lt"), 8, pa.n_words,
                              spec.plan(pa.n_words), n_devices=n)
        meta[f"tile_ledger_{n}"] = _ledger(RLEDGER)
    # cim.multiply on a mesh: tests/test_cim_program.py:241
    rng = np.random.RandomState(1)
    arrays["mul_x"] = rng.randint(-100, 100, 70).astype(np.int32)
    arrays["mul_y"] = rng.randint(-100, 100, 70).astype(np.int32)
    meta["mul_placed"] = rplanner.plan_multiply(8, 8).placed(
        RSpec(banks=2, subarrays=1, rows=256, bitline_words=32),
        70).placed_accesses
    # lower on a banked spec (the reference unsharded)
    rng = np.random.RandomState(2)
    la = rng.randint(-40, 40, 200).astype(np.int16)
    lb = rng.randint(-40, 40, 200).astype(np.int16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "Literal", jex.Literal, raising=False)
        mp.setattr(jax.core, "Var", jex.Var, raising=False)
        RLEDGER.reset()
        rout = rlower(lambda u, v: (u + v) * v, backend="jnp-boolean",
                      spec=RSpec(banks=2, subarrays=1, rows=256,
                                 bitline_words=32))(jnp.asarray(la),
                                                    jnp.asarray(lb))
    arrays["low_a"], arrays["low_b"] = la, lb
    arrays["low_out"] = np.asarray(rout)
    meta["low_accesses"] = RLEDGER.accesses
    meta["low_bank_total"] = sum(RLEDGER.bank_accesses.values())
    RLEDGER.reset()
    np.savez(os.path.join(work, "inputs.npz"), **arrays)
    with open(os.path.join(work, "inputs.json"), "w") as f:
        json.dump(meta, f)
    return meta


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference's numbers, then the 8-rank child's results."""
    work = str(tmp_path_factory.mktemp("gloo"))
    meta = _reference_inputs(work)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-W", "ignore",
                        os.path.join(ROOT, "tests", "_torch_gloo_ranks.py"),
                        work], capture_output=True, text=True, timeout=600,
                       env=env)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    with open(os.path.join(work, "results.json")) as f:
        return meta, json.load(f)


def _case(ranks, name):
    meta, results = ranks
    res = results[name]
    assert res["ok"], res.get("error")
    return meta, res


#: the vocab-parallel embedding's all-reduce, and the CE's sums over the
#: vocab blocks for the one 64-token chunk, run again by its checkpoint in
#: the backward
EMBED_AND_CE = 1 + 2
#: tensor-parallel regions (`rules.tp_exit` calls) a reduced train step
#: runs, one per layer part split over "model" (2 layers, 6 for the
#: hybrid): attention or MLA, a dense MLP, the RG-LRU block, a MoE layer's
#: routed experts under "tp" sharding and its shared experts; deepseek's 4
#: experts are "ep" on 2 "model" ranks (gathered whole) and "tp" on 8
TP_REGIONS = {
    "train_4x2": 2 * 2 + EMBED_AND_CE,
    "moe_train_4x2": 2 + 1 + 1 + EMBED_AND_CE,
    "gemma_train_4x2": 2 * 2 + EMBED_AND_CE,
    "rg_train_4x2": 6 * 2 + EMBED_AND_CE,
    "grok_train_4x2": 2 * 2 + EMBED_AND_CE,
    "train_1x8": 2 * 2 + EMBED_AND_CE,
    "moe_train_1x8": 2 + 1 + 1 + 1 + EMBED_AND_CE,
}
#: the "model"-sharded weights a step gathers whole: the kv weights of
#: attention split by head whose single kv head the specs split by head_dim
#: (each rank's query heads read it whole, as GSPMD gathers it), and
#: expert weights under "ep" sharding (gathered at their use, as the
#: reference's are)
WHOLE = {
    "moe_train_4x2": {f"layers.1.mlp.{k}" for k in ("w_in", "w_gate",
                                                    "w_out")},
    "gemma_train_4x2": {f"layers.{i}.attn.{k}" for i in (0, 1)
                        for k in ("wk", "wv")},
    "rg_train_4x2": {f"layers.{i}.attn.{k}" for i in (2, 5)
                     for k in ("wk", "wv")},
}


def _assert_train_matches(meta, res, key, case):
    assert res["n_dtensor"] == res["n_params"]
    assert res["moment_dtensor"] == "DTensor"
    assert res["tp_regions"] == [TP_REGIONS[case]] * 2
    assert set(res["params_whole"]) == WHOLE.get(case, set())
    assert res["caches_whole"] == 0
    np.testing.assert_allclose(res["loss"], meta[key + "_loss"], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(res["grad_norm"], meta[key + "_grad_norm"],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case,key", [("train_4x2", "train"),
                                      ("train_moe_4x2", "moe_train")])
def test_sharded_train_step_matches_reference_loss(ranks, case, key):
    meta, res = _case(ranks, case)
    _assert_train_matches(meta, res, key, key + "_4x2")


@pytest.mark.parametrize("case", ["gemma_train_4x2", "rg_train_4x2",
                                  "grok_train_4x2", "train_1x8",
                                  "moe_train_1x8"])
def test_tensor_parallel_train_step_matches_reference(ranks, case):
    """The whole step split over "model" (vocab-parallel embedding and
    CE; attention by head, or by head_dim with 4 heads on 8 ranks; MLA;
    the RG-LRU block by channel; MoE experts by hidden dim): losses and
    grad norms within 1e-5 of the reference's single-device step, the
    regions counted, and nothing "model"-sharded gathered whole but the
    named cases."""
    meta, res = _case(ranks, "tp_train")
    _assert_train_matches(meta, res[case], case.rsplit("_", 1)[0], case)


@pytest.mark.parametrize("key", ["train", "moe_train", "rg_train"])
def test_tensor_parallel_prefill_and_decode_match_reference(ranks, key):
    """Reduced llama3.2-1b, deepseek-v2-lite-16b and recurrentgemma-9b on
    4x2: a sharded prefill and 4 decode steps within 1e-5 of the
    reference's unsharded logits; each rank keeps its 2 rows and its
    "model" block of every cache's feature dim, and joins none whole."""
    _, res = _case(ranks, "tp_serve")
    r = res[key]
    assert max(r["err"]) <= 1e-5, r["err"]
    assert r["caches_whole"] == 0
    want = {"train": set(), "moe_train": WHOLE["moe_train_4x2"],
            "rg_train": WHOLE["rg_train_4x2"]}[key]
    assert set(r["params_whole"]) == want
    # reduced widths: head_dim 16, latent 32, rope 8, d_model 64; halves
    width = {"k": 8, "v": 8, "c_kv": 16, "k_rope": 4, "h": 32, "conv": 32}
    for name, shape in r["cache_shapes"].items():
        assert shape[0] == 2 and shape[-1] == width[name.split("/")[1]], \
            (name, shape)


def test_elastic_restore_across_meshes(ranks):
    _, res = _case(ranks, "elastic")
    for shape in ("2x4", "8x1"):
        assert res[shape]["equal"], shape
        assert res[shape]["dtensors"] == res[shape]["leaves"]
    assert res["in_place"]


@pytest.mark.parametrize("mesh", ["2x4", "1x8", "4x2"])
def test_moe_ep_matches_reference(ranks, mesh):
    _, res = _case(ranks, "moe_ep")
    assert res[mesh]["shape"] == [4, 16, 64]
    assert res[mesh]["err"] < 2e-5, res[mesh]["err"]


@pytest.mark.parametrize("mesh", ["2x4", "1x8", "4x2"])
def test_moe_ep_reads_its_own_experts_of_sharded_weights(ranks, mesh):
    """Expert weights as DTensors with the experts on "model": the same
    output, and only the router is gathered whole (each rank reads its
    own experts' block)."""
    _, res = _case(ranks, "moe_ep")
    assert res[mesh]["err_dtensor"] < 2e-5, res[mesh]["err_dtensor"]
    assert res[mesh]["gathered_whole"] == [[64, 8]]


@pytest.mark.parametrize("n_data", [1, 2, 4])
def test_execute_sharded_matches_reference(ranks, n_data):
    _, res = _case(ranks, "cim")
    r = res[str(n_data)]
    assert r["tile_sub"] and r["tile_lt"] and r["tile_planes"]
    assert r["tile_ledger"], r["tile_per_device"]
    assert len(r["tile_per_device"]) == n_data


@pytest.mark.parametrize("n_data", [1, 2, 4])
def test_multiply_on_mesh_matches_reference(ranks, n_data):
    meta, res = _case(ranks, "cim")
    r = res[str(n_data)]
    assert r["mul_bits"]
    assert r["mul_accesses"] == meta["mul_placed"]


@pytest.mark.parametrize("n_data", [1, 2, 4])
def test_lower_on_mesh_matches_reference(ranks, n_data):
    meta, res = _case(ranks, "cim")
    r = res[str(n_data)]
    assert r["lower_out"]
    assert r["lower_accesses"] == meta["low_accesses"]
    assert r["lower_bank_total"] == meta["low_bank_total"]


def test_activation_hints_on_mesh(ranks):
    _, res = _case(ranks, "hints")
    assert res["identity_off_mesh"] and res["plain"] and res["ok_types"]
    assert res["activation"] == ["Shard(dim=0)", "Shard(dim=1)"]
    assert res["activation_equal"]
    assert res["short"] == ["Shard(dim=0)", "Replicate()"]
    assert res["batch"] == ["Shard(dim=0)", "Replicate()"]
