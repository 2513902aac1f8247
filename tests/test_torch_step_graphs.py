"""The reference's jitted float steps as programs in the port: the prefill,
the float decode step with its caches donated, the slot insert and the
one-card train step with its state donated (`dispatch.Program`, one CUDA
graph per signature on the card), and the steady windows that leave out
every call that compiled (an eager first call or a capture).

The CPU has no CUDA graph, so the graph cases inject a stand-in that keeps
a real graph's contract: the capture runs the body once under
`dispatch.CaptureGuard` (for its static outputs) and traces it with
`make_fx`, then sets every input back, as a capture computes nothing; a
replay runs the trace on the static inputs. A trace, like a graph, freezes
every host value at capture: a Python slot or learning rate baked into a
body would replay as the captured one. The reduced models and the 2-layer
bench config take inputs and weights from seeds (numpy, or the reference's
init carried over with `params_from_jax`); every graphed result is held to
the eager body's to the bit and to the reference's within its existing
tolerance (2e-4 for a model's logits, `tests/test_torch_train.py`'s loss
tolerance for a train step).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro.configs import get_config as r_get_config
from repro.configs.base import ArchConfig as RArch
from repro.data import DataConfig as RDataConfig
from repro.data import synthetic_batch as r_synthetic_batch
from repro.launch import serve as rserve
from repro.models import build as rbuild
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import cosine_schedule as r_cosine_schedule
from repro.train import init_state as r_init_state
from repro.train import make_train_step as r_make_train_step
from repro_torch import tree
from repro_torch.cim import array as tarray
from repro_torch.cim import dispatch as tdisp
from repro_torch.cim.accounting import LEDGER as TLEDGER
from repro_torch.cim.autotune import WARMUP_CALLS, steady_ms
from repro_torch.cim.opset import CimOpError
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.train import (init_state, make_decode_step,
                               make_prefill_step, make_train_step)

#: the reference's prefill/decode-vs-forward tolerance
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
#: tests/test_torch_train.py's loss tolerance
LOSS_TOL = dict(atol=1e-5, rtol=1e-6)
#: the cache kinds, each on the reduced config that holds it: dense GQA
#: (llama3.2-1b), the local ring and RG-LRU state (recurrentgemma-9b), MLA
#: (deepseek-v2-lite-16b, MoE layers float), mLSTM and sLSTM states
#: (xlstm-125m)
CACHE_KINDS = {"dense-gqa": "llama3.2-1b",
               "local-ring-rglru": "recurrentgemma-9b",
               "mla": "deepseek-v2-lite-16b",
               "mlstm-slstm": "xlstm-125m"}


@pytest.fixture(autouse=True)
def _fresh_state():
    """A clean port ledger and program table, and one intra-op thread
    (see tests/test_torch_rglru.py)."""
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


def _restore(tensors, values):
    with torch.no_grad():
        for t, v in zip(tensors, values):
            t.copy_(v)


class TracedGraph:
    """A CUDA graph's contract on the CPU: a `make_fx` trace of the body
    over its static inputs, replayed into the static outputs (those that
    are static inputs, a donated leaf's, are written by the trace itself).
    A replay runs no Python of the body, so no counter moves."""

    def __init__(self, gm, inputs, out):
        self.gm, self.inputs = gm, inputs
        self.outputs = []
        tdisp._flatten(out, self.outputs)

    def replay(self):
        # the trace holds the backward's ops too: a replay, like a graph's,
        # records no autograd
        with torch.no_grad():
            for o, f in zip(self.outputs, self.gm(*self.inputs)):
                if o is not f:
                    o.copy_(f)


def _trace(fn, args):
    """(the body's outputs, its make_fx trace), the static inputs `args`
    set back to their values before: a capture computes nothing."""
    flat = []
    template = tdisp._flatten(args, flat)
    before = [t.detach().clone() for t in flat]
    with tdisp.CaptureGuard():
        out = fn(*args)
    _restore(flat, before)

    def flat_fn(*ts):
        res = []
        tdisp._flatten(fn(*tdisp._unflatten(template, iter(ts))), res)
        return res
    c0 = tdisp._counters()
    gm = make_fx(flat_fn)(*flat)
    tdisp._add_counters(tuple(a - b for a, b in zip(c0, tdisp._counters())))
    _restore(flat, before)
    return out, TracedGraph(gm, flat, out)


@pytest.fixture
def traced(monkeypatch):
    """Programs on CPU tensors take the graph path, captured (under the
    capture guard) into traced stand-ins; returns the list of captures."""
    graphs = []

    def record(fn, args, device):
        assert device == torch.device("cpu")
        tdisp._CAPTURING = True
        try:
            out, graph = _trace(fn, args)
        finally:
            tdisp._CAPTURING = False
        graphs.append(graph)
        return graph, out

    def graph_device(tensors):
        return None if tdisp._EAGER or not tensors else torch.device("cpu")

    monkeypatch.setattr(tdisp, "_record", record)
    monkeypatch.setattr(tdisp, "_graph_device", graph_device)
    return graphs


def _models(arch):
    rcfg, tcfg = r_get_config(arch).reduced(), t_get_config(arch).reduced()
    rmodel = rbuild(rcfg)
    np_params = jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(0)))
    tmodel = Model(tcfg, params=params_from_jax(np_params, tcfg,
                                                device="cpu"))
    return rmodel, jax.tree.map(jnp.asarray, np_params), tmodel


def _clone(tree_):
    if isinstance(tree_, dict):
        return {k: _clone(v) for k, v in tree_.items()}
    if isinstance(tree_, (list, tuple)):
        return type(tree_)(_clone(v) for v in tree_)
    return tree_.clone()


def _same_tree(a, b):
    xs, ys = tree.leaves(a), tree.leaves(b)
    return len(xs) == len(ys) and all(torch.equal(x, y)
                                      for x, y in zip(xs, ys))


# ---------------------------------------------------------------------------
# capture safety of every float body
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(set(CACHE_KINDS.values()))
                         + ["gemma-2b", "musicgen-large"])
def test_float_bodies_run_under_the_capture_guard(arch):
    """The prefill, the donated decode, the insert and the donated train
    step of each family run under `CaptureGuard`: no tensor built from host
    data, no host read of a device value, no shape that depends on the
    data. Each held before as `torch.tensor` of a host value: attention's
    masks and scales, AdamW's betas and learning rate; and the MoE
    router's `one_hot`, which reads its indices' range on the host."""
    cfg = t_get_config(arch).reduced()
    model = Model(cfg, device="cpu", seed=3)
    rng = np.random.default_rng(3)
    if cfg.embed_stub:
        prompt = {"embeds": torch.from_numpy(rng.standard_normal(
            (1, 9, cfg.d_model)).astype(np.float32) * 0.02)}
        step = {"embeds": torch.zeros((2, 1, cfg.d_model))}
        batch = {"embeds": torch.from_numpy(rng.standard_normal(
            (2, 16, cfg.d_model)).astype(np.float32) * 0.02)}
    else:
        prompt = {"tokens": torch.from_numpy(rng.integers(0, 256, (1, 9)))}
        step = {"tokens": torch.tensor([[3], [5]])}
        batch = {"tokens": torch.from_numpy(rng.integers(0, 256, (2, 16)))}
    step["positions"] = torch.tensor([9, 4], dtype=torch.int32)
    batch["targets"] = torch.from_numpy(rng.integers(0, 256, (2, 16)))
    caches = model.init_caches(2, 16)
    opt = AdamWConfig(lr=1e-3)
    state = init_state(model, opt)
    train = tdisp._donating(make_train_step(
        model, opt, lr_schedule=cosine_schedule(1e-3, 2, 10)), (0,))
    slot = torch.tensor([1])
    with tdisp.CaptureGuard():
        single, _ = make_prefill_step(model, 16)(prompt)
        tdisp._donating(tserve._insert_body, (0,))(caches, single, slot)
        tdisp._donating(make_decode_step(model), (0,))(caches, step)
        train(state, batch)
        train(state, dict(batch))          # AdamW's count past 1


@pytest.mark.parametrize("arch", sorted(set(CACHE_KINDS.values()))
                         + ["gemma-2b", "musicgen-large"])
def test_float_bodies_read_no_host_tensor_on_a_device(arch):
    """The same bodies on `meta` tensors under a guard for that device,
    the train step with per-layer recomputation, 2 microbatches and 64
    positions (the chunkwise mLSTM inside a recomputed layer): no op reads
    a host tensor or makes one with data, as a capture on the card
    requires."""
    meta = torch.device("meta")
    cfg = dataclasses.replace(t_get_config(arch).reduced(), remat=True,
                              microbatches=2)
    model = Model(cfg, device=meta)

    def zeros(*shape, dtype=torch.int64):
        return torch.zeros(shape, dtype=dtype, device=meta)
    if cfg.embed_stub:
        prompt = {"embeds": zeros(1, 9, cfg.d_model, dtype=torch.float32)}
        step = {"embeds": zeros(2, 1, cfg.d_model, dtype=torch.float32)}
        batch = {"embeds": zeros(2, 64, cfg.d_model, dtype=torch.float32)}
    else:
        prompt, step = {"tokens": zeros(1, 9)}, {"tokens": zeros(2, 1)}
        batch = {"tokens": zeros(2, 64)}
    step["positions"] = zeros(2, dtype=torch.int32)
    batch["targets"] = zeros(2, 64)
    caches = model.init_caches(2, 16)
    opt = AdamWConfig(lr=1e-3)
    state = init_state(model, opt)
    train = tdisp._donating(make_train_step(
        model, opt, lr_schedule=cosine_schedule(1e-3, 2, 10)), (0,))
    slot = zeros(1)
    with tdisp.CaptureGuard(meta):
        single, _ = make_prefill_step(model, 16)(prompt)
        tdisp._donating(tserve._insert_body, (0,))(caches, single, slot)
        tdisp._donating(make_decode_step(model), (0,))(caches, step)
        train(state, batch)


# ---------------------------------------------------------------------------
# donation: the program's bookkeeping
# ---------------------------------------------------------------------------


def _accumulate(state, x):
    """A functional body: a new state (sum and count) and a metric."""
    new = {"sum": state["sum"] + x, "n": state["n"] + 1}
    return new, new["sum"] * 2


def test_donated_leaf_is_the_static_input_and_comes_back_as_is(traced):
    """The capture takes the caller's own tensors of a donated leaf as the
    graph's static inputs: every call leaves the new state in them and
    returns them, not clones; the other output is a fresh clone each
    call."""
    state = {"sum": torch.zeros(3), "n": torch.zeros((), dtype=torch.int64)}
    held = (state["sum"], state["n"])
    prog = tdisp.Program(_accumulate, donate=(0,))
    outs = []
    for i in range(4):                    # eager, capture, replay, replay
        x = torch.full((3,), float(i + 1))
        new, twice = prog(state, x)
        assert new["sum"] is held[0] and new["n"] is held[1]
        outs.append(twice)
    assert traced[0].inputs[0] is held[0] and traced[0].inputs[1] is held[1]
    assert torch.equal(state["sum"], torch.full((3,), 10.0))
    assert int(state["n"]) == 4
    assert [float(o[0]) for o in outs] == [2.0, 6.0, 12.0, 20.0]
    assert len({o.data_ptr() for o in outs}) == 4


def test_other_tensors_for_a_donated_leaf_are_copied_in(traced):
    """A call that passes other tensors for a donated leaf (a restore that
    built new ones) has them copied into the static inputs: the step
    continues from their values."""
    state = {"sum": torch.zeros(3), "n": torch.zeros((), dtype=torch.int64)}
    prog = tdisp.Program(_accumulate, donate=(0,))
    for _ in range(2):
        prog(state, torch.ones(3))
    other = {"sum": torch.full((3,), 100.0),
             "n": torch.full((), 7, dtype=torch.int64)}
    new, twice = prog(other, torch.ones(3))
    assert torch.equal(new["sum"], torch.full((3,), 101.0))
    assert int(new["n"]) == 8 and float(twice[0]) == 202.0
    assert prog.stats["captured"] == 1


def test_eager_programs_runs_a_donated_step_eagerly(traced):
    """Inside `eager_programs()` a step program runs its eager body (no
    capture, no replay) and still leaves its new state in the donated
    tensors."""
    state = {"sum": torch.zeros(3), "n": torch.zeros((), dtype=torch.int64)}
    prog = tdisp.Program(_accumulate, donate=(0,))
    with tdisp.eager_programs():
        for _ in range(3):
            new, _ = prog(state, torch.ones(3))
            assert new["sum"] is state["sum"]
    assert int(state["n"]) == 3 and not traced
    assert prog.stats == {"captured": 0, "replays": 0, "capture_s": 0.0,
                          "eager": 0}


def test_a_donated_result_that_does_not_match_raises(traced):
    prog = tdisp.Program(lambda s, x: ({"sum": s["sum"]}, x), donate=(0,))
    with pytest.raises(CimOpError, match="donated leaf 0"):
        prog({"sum": torch.zeros(2), "n": torch.zeros(())}, torch.ones(2))
    prog = tdisp.Program(lambda s: ({"sum": s["sum"].double()},),
                         donate=(0,))
    with pytest.raises(CimOpError, match="donated leaf 0"):
        prog({"sum": torch.zeros(2)})


# ---------------------------------------------------------------------------
# the donated float decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(CACHE_KINDS))
def test_donated_decode_equals_eager_and_reference(traced, kind):
    """Prefill 9 positions, then 4 decode steps through the donated decode
    program (eager, capture, replay, replay): logits and every new cache
    equal to the eager `decode_step` to the bit, the caller's cache
    tensors updated in place (the same objects every step), and the logits
    within the reference's tolerance of its jitted decode."""
    rmodel, rparams, tmodel = _models(CACHE_KINDS[kind])
    cfg = tmodel.cfg
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 13)).astype(np.int32)
    rc, _ = jax.jit(rmodel.prefill, static_argnums=2)(
        rparams, {"tokens": jnp.asarray(toks[:, :9])}, 13)
    rdecode = jax.jit(rmodel.decode_step)
    caches, _ = tmodel.prefill({"tokens": torch.from_numpy(
        toks[:, :9]).long()}, max_len=13)
    eager = _clone(caches)
    held = tree.leaves(caches)
    prog = tdisp.Program(make_decode_step(tmodel), donate=(0,))
    for t in range(9, 13):
        inp = {"tokens": torch.from_numpy(toks[:, t:t + 1]).long(),
               "positions": torch.full((2,), t, dtype=torch.int32)}
        out, logits = prog(caches, inp)
        eager, want = tmodel.decode_step(eager, inp)
        assert out is not None and tree.leaves(out) == held
        assert all(a is b for a, b in zip(tree.leaves(caches), held))
        assert torch.equal(logits, want), t
        assert _same_tree(caches, eager), t
        rc, rlog = rdecode(rparams, rc, {
            "tokens": jnp.asarray(toks[:, t:t + 1]),
            "positions": jnp.full((2,), t, jnp.int32)})
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlog),
                                   **MODEL_TOL)
    assert prog.stats["eager"] == 1 and prog.stats["captured"] == 1
    assert prog.stats["replays"] == 3 and len(traced) == 1


# ---------------------------------------------------------------------------
# the float serve engine with graphs on
# ---------------------------------------------------------------------------

#: the 2-layer bench config on the float path
_DENSE_KW = dict(name="bench-float", family="dense", n_layers=2, d_model=16,
                 n_heads=4, n_kv_heads=2, head_dim=8, d_ff=32,
                 vocab_size=64, dtype="float32", tensor_parallel=False)


def _engine_models(which):
    if which == "dense-2-layer":
        rcfg, tcfg = RArch(**_DENSE_KW), TArch(**_DENSE_KW)
    else:
        rcfg = r_get_config(which).reduced()
        tcfg = t_get_config(which).reduced()
    rmodel = rbuild(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(2))
    tmodel = Model(tcfg, params=params_from_jax(
        jax.tree.map(np.asarray, rparams), tcfg, device="cpu"))
    return rmodel, rparams, tmodel


@pytest.mark.parametrize("which", ["dense-2-layer", "recurrentgemma-9b",
                                   "xlstm-125m"])
def test_float_serve_engine_tokens_match_reference_with_graphs(traced,
                                                               which):
    """3 requests of 5 prompt tokens and 4 generated on 2 slots (the third
    lands in slot 0 after the insert program was captured): the port's
    float engine, its prefill, decode and insert replaying traced graphs,
    gives the reference engine's greedy tokens; each step program
    captured once and replayed after."""
    rmodel, rparams, tmodel = _engine_models(which)
    gen, plen = 4, 5
    reng = rserve.ServeEngine(rmodel, rparams, slots=2, max_len=plen + gen,
                              cim_lower=False, warmup_steps=1)
    rrep = reng.run([rserve.ServeRequest(rid=i, prompt_len=plen, gen=gen)
                     for i in range(3)])
    prompts = [np.asarray(reng._prompt_inputs(rserve.ServeRequest(
        rid=i, prompt_len=plen, gen=gen))["tokens"])[0].tolist()
        for i in range(3)]
    reqs = [tserve.ServeRequest(rid=i, prompt_len=plen, gen=gen,
                                prompt=prompts[i]) for i in range(3)]
    eng = tserve.ServeEngine(tmodel, slots=2, max_len=plen + gen)
    rep = eng.run(reqs)
    assert [r.slot for r in reqs] == [0, 1, 0]
    assert [r["token_ids"] for r in rep["per_request"]] == \
        [r["token_ids"] for r in rrep["per_request"]]
    graphs = rep["step_graphs"]
    for name in ("prefill", "decode", "insert"):
        assert graphs[name]["eager"] == graphs[name]["captured"] == 1, name
        assert graphs[name]["replays"] > 0, name
    assert [r["prefill_kind"] for r in rep["per_request"]] == \
        ["eager", "capture", "replay"]
    assert TLEDGER.accesses == 0


def test_inserts_land_in_slots_0_and_1_after_capture(traced):
    """The insert program's slot is a device integer: after the capture
    (with slot 1), inserts into slots 0 and 1 each land in their own row
    and leave the other as it was; a Python slot frozen at capture would
    replay into row 1 every time."""
    model = Model(t_get_config("recurrentgemma-9b").reduced(), device="cpu",
                  seed=5)
    eng = tserve.ServeEngine(model, slots=2, max_len=12)
    caches = model.init_caches(2, 12)
    held = tree.leaves(caches)
    rng = np.random.default_rng(8)
    singles = [model.prefill({"tokens": torch.from_numpy(
        rng.integers(0, 256, (1, 7)))}, max_len=12)[0] for _ in range(4)]
    for single, slot in zip(singles, (0, 1, 0, 1)):   # eager, capture, ...
        before = _clone(caches)
        eng._insert(caches, single, slot)
        assert all(a is b for a, b in zip(tree.leaves(caches), held))
        for c, s, b in zip(caches, single, before):
            for name in c:
                assert torch.equal(c[name][slot], s[name][0]), (slot, name)
                assert torch.equal(c[name][1 - slot], b[name][1 - slot])
    stats = eng.programs["insert"].stats
    assert (stats["eager"], stats["captured"], stats["replays"]) == (1, 1, 3)


# ---------------------------------------------------------------------------
# the donated train step
# ---------------------------------------------------------------------------


def test_graphed_train_step_equals_eager_and_reference(traced):
    """Reduced gemma-2b, 3 steps of 4 x 16 under a cosine schedule whose
    warmup moves the learning rate every step: the donated step program
    (eager, capture, replay) gives eager's losses, grad norms, learning
    rates and parameters to the bit, the state's tensors updated in place
    (its step counter and AdamW count included), and the reference's
    jitted step's loss within `tests/test_torch_train.py`'s tolerance."""
    arch = "gemma-2b"
    rcfg = r_get_config(arch).reduced()
    rmodel = rbuild(rcfg)
    rstate = r_init_state(rmodel, jax.random.PRNGKey(0),
                          RAdamWConfig(lr=1e-3))
    np_params = jax.tree.map(np.asarray, rstate["params"])
    rstep = jax.jit(r_make_train_step(
        rmodel, RAdamWConfig(lr=1e-3),
        lr_schedule=r_cosine_schedule(1e-3, 5, 10)))
    tcfg = t_get_config(arch).reduced()
    models = [Model(tcfg, params=params_from_jax(np_params, tcfg,
                                                 device="cpu"))
              for _ in range(2)]
    opt = AdamWConfig(lr=1e-3)
    sched = cosine_schedule(1e-3, 5, 10)
    graphed_state, eager_state = (init_state(m, opt) for m in models)
    held = tree.leaves(graphed_state)
    prog = tdisp.Program(make_train_step(models[0], opt, lr_schedule=sched),
                         donate=(0,))
    eager = make_train_step(models[1], opt, lr_schedule=sched)
    lrs = []
    for s in range(3):
        b = r_synthetic_batch(s, RDataConfig(vocab_size=rcfg.vocab_size,
                                             batch=4, seq_len=16))
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        out, got = prog(graphed_state, batch)
        eager_state, want = eager(eager_state, batch)
        assert tree.leaves(out) == held
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert torch.equal(got[k], want[k]), (s, k)
        assert _same_tree(graphed_state, eager_state), s
        assert int(graphed_state["step"]) == s + 1
        assert int(graphed_state["opt"]["count"]) == s + 1
        rstate, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in b.items()})
        np.testing.assert_allclose(float(got["loss"]), float(rm["loss"]),
                                   **LOSS_TOL)
        np.testing.assert_allclose(float(got["lr"]), float(rm["lr"]),
                                   **LOSS_TOL)
        lrs.append(float(got["lr"]))
    assert len(set(lrs)) == 3                  # the schedule moved
    assert (prog.stats["eager"], prog.stats["captured"],
            prog.stats["replays"]) == (1, 1, 2)


def test_train_driver_leaves_capture_steps_out(traced, tmp_path):
    """The train entry point on reduced llama3.2-1b, 4 steps: step 1 runs
    the program's eager first call and step 2 captures, so both are out of
    the steady window; steps 3 and 4 replay and are its only steps."""
    rep = ttrain.main(["--preset", "reduced", "--device", "cpu", "--steps",
                       "4", "--batch", "2", "--seq", "16", "--ckpt-dir",
                       str(tmp_path), "--ckpt-every", "100"])
    assert [r["compiled"] for r in rep["records"]] == \
        [True, True, False, False]
    assert rep["capture_steps"] == [0, 1]
    assert (rep["graphs"]["eager"], rep["graphs"]["captured"],
            rep["graphs"]["replays"]) == (1, 1, 3)
    steady_ms_ = sum(r["ms"] for r in rep["records"][2:])
    assert rep["tok_s_steady"] == pytest.approx(2 * 2 * 16 / (steady_ms_
                                                              / 1e3))


# ---------------------------------------------------------------------------
# steady windows (C1)
# ---------------------------------------------------------------------------


def test_serve_step_that_captured_is_out_of_the_steady_window(traced):
    """2-layer float serve, 2 requests of 4 tokens and 6 generated on 2
    slots: decode step 1 runs the decode program's eager first call and
    step 2 captures; both are capture steps, out of p50, p99 and steady
    tok/s, which hold exactly the replayed steps. The first prefill is
    eager, the second captures: no prefill replayed."""
    tmodel = Model(TArch(**_DENSE_KW), device="cpu", seed=1)
    reqs = [tserve.ServeRequest(rid=i, prompt_len=4, gen=6)
            for i in range(2)]
    rep = tserve.ServeEngine(tmodel, slots=2, max_len=10).run(reqs)
    assert rep["capture_steps"] == [1, 2]
    assert len(rep["capture_step_ms"]) == 2
    assert len(rep["step_capture_s"]) == rep["decode_steps"] == 5
    steady = rep["decode_steps"] - 2
    assert rep["steady_tokens"] == 2 * steady
    lat = reqs[0].token_latencies_ms[2:]
    assert rep["p50_ms"] in lat and rep["p99_ms"] in lat
    assert rep["tok_s_steady"] == pytest.approx(
        2 * steady / (sum(lat) / 1e3))
    assert [r["prefill_kind"] for r in rep["per_request"]] == \
        ["eager", "capture"]
    assert rep["prefill_ms_replay_mean"] is None
    assert rep["graphs"]["captured"] == 3     # prefill, insert, decode


def test_serve_on_a_plain_device_has_no_capture_steps():
    """Without a graph device nothing compiles: only the warmup step is
    out of the window, as before."""
    tmodel = Model(TArch(**_DENSE_KW), device="cpu", seed=1)
    reqs = [tserve.ServeRequest(rid=i, prompt_len=4, gen=4)
            for i in range(2)]
    rep = tserve.ServeEngine(tmodel, slots=2, max_len=8).run(reqs)
    assert rep["capture_steps"] == [] and rep["steady_tokens"] == 2 * 2
    assert {r["prefill_kind"] for r in rep["per_request"]} == {"eager"}
    assert rep["graphs"] == {"captured": 0, "replays": 0, "capture_s": 0.0,
                             "eager": 0}


def _doubler():
    return tdisp.Program(lambda x: (x * 2,))


def test_steady_ms_times_no_capture(traced):
    """`steady_ms` warms a program up through its eager first call and its
    capture (3 calls: eager, capture, replay), then times replays only."""
    prog = _doubler()
    x = torch.arange(6.0)
    seen = []

    def fn():
        seen.append(tdisp.graph_stats())
        return prog(x)

    assert steady_ms(fn, n=4) >= 0.0 and len(seen) == 3 + 4
    # the capturing call replays its graph too, as on the card
    assert (prog.stats["eager"], prog.stats["captured"],
            prog.stats["replays"]) == (1, 1, 6)
    # every timed call started after the capture
    assert all(s["captured"] == 1 and s["eager"] == 1 for s in seen[3:])


def test_steady_ms_raises_when_a_timed_call_compiles(traced):
    """A program that meets a new signature at every call never settles:
    after `WARMUP_CALLS` warm-up calls a timed call still compiles, and
    `steady_ms` raises rather than time it."""
    prog = _doubler()
    n = iter(range(1, 100))
    with pytest.raises(CimOpError, match="compiled"):
        steady_ms(lambda: prog(torch.zeros(next(n))), n=2)
    assert prog.stats["eager"] == WARMUP_CALLS + 2
