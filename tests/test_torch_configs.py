"""Port vs reference: the registry's ten configurations and what serving
and training them needs: the alias modules, `embed_stub_batch`, embed-stub
serve inputs, the serve model's compute-dtype weights, the resident pin
bookkeeping (`_decode_weight_pins`). The reduced `--cim-lower` decode-step
counts of the new configs are in tests/test_torch_config_counts.py.
"""
import argparse
import dataclasses
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.cim import array as rarray
from repro.cim import dispatch as rdisp
from repro.cim.accounting import LEDGER as RLEDGER
from repro.configs import ARCH_IDS as R_ARCH_IDS
from repro.configs import get_config as r_get_config
from repro.data.pipeline import embed_stub_batch as r_embed_stub_batch
from repro.launch.paged_kv import PagedKV as RPaged
from repro_torch.cim import array as tarray
from repro_torch.cim import dispatch as tdisp
from repro_torch.cim import planner
from repro_torch.cim.accounting import LEDGER as TLEDGER
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import embed_stub_batch
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.paged_kv import PagedKV as TPaged
from repro_torch.models.model import _cast_rule, build, stack_kinds, with_cim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the port's one field the reference lacks (the quantized host twins)
PORT_ONLY = {"cim_host_twin": False}
#: the reference's per-arch modules (src/repro/configs/*.py)
ALIASES = {"deepseek_v2_lite_16b": "deepseek-v2-lite-16b",
           "gemma_2b": "gemma-2b", "granite3_8b": "granite-3-8b",
           "grok1_314b": "grok-1-314b", "internvl2_26b": "internvl2-26b",
           "llama32_1b": "llama3.2-1b", "musicgen_large": "musicgen-large",
           "qwen3_14b": "qwen3-14b", "recurrentgemma_9b": "recurrentgemma-9b",
           "xlstm_125m": "xlstm-125m"}


@pytest.fixture(autouse=True)
def _fresh_state():
    for clear in (TLEDGER.reset, tarray.clear_resident,
                  tdisp.clear_schedule_cache, rdisp.clear_schedule_cache,
                  RLEDGER.reset, rarray.clear_resident):
        clear()
    yield
    for clear in (TLEDGER.reset, tarray.clear_resident,
                  tdisp.clear_schedule_cache, rdisp.clear_schedule_cache,
                  RLEDGER.reset, rarray.clear_resident):
        clear()


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_arch_ids_are_the_reference_ten():
    assert ARCH_IDS == R_ARCH_IDS
    assert len(ARCH_IDS) == 10


@pytest.mark.parametrize("arch", R_ARCH_IDS)
def test_full_and_reduced_configs_equal_reference(arch):
    """Field for field, the published config and its CPU reduction (and
    the port's own field at its default)."""
    for t, r in ((get_config(arch), r_get_config(arch)),
                 (get_config(arch).reduced(), r_get_config(arch).reduced())):
        assert dataclasses.asdict(t) == {**dataclasses.asdict(r),
                                         **PORT_ONLY}
    cfg = get_config(arch)
    assert (cfg.vocab_padded, cfg.q_dim, cfg.kv_dim) == (
        r_get_config(arch).vocab_padded, r_get_config(arch).q_dim,
        r_get_config(arch).kv_dim)


@pytest.mark.parametrize("module", sorted(ALIASES))
def test_alias_modules_load_the_registry_entry(module):
    ref = importlib.import_module(f"repro.configs.{module}")
    mod = importlib.import_module(f"repro_torch.configs.{module}")
    assert mod.CONFIG is get_config(ALIASES[module])
    assert dataclasses.asdict(mod.CONFIG) == {
        **dataclasses.asdict(ref.CONFIG), **PORT_ONLY}


def test_stack_kinds_put_the_dense_prefix_first():
    """The reference's stack order: `first_dense` layers (attention with a
    dense MLP), then the pattern over the rest."""
    ds = get_config("deepseek-v2-lite-16b")
    assert stack_kinds(ds) == ("attn",) * 27
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if not cfg.first_dense_layers:
            assert stack_kinds(cfg) == cfg.pattern_layers(), arch
    mixed = dataclasses.replace(get_config("recurrentgemma-9b"),
                                first_dense_layers=2, n_layers=7)
    assert stack_kinds(mixed) == ("attn", "attn", "rec", "rec", "local",
                                  "rec", "rec")


# ---------------------------------------------------------------------------
# embed-stub inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,step,seed", [
    ("musicgen-large", 0, 0), ("musicgen-large", 7, 3),
    ("internvl2-26b", 2, 1)])
def test_embed_stub_batch_equals_reference(arch, step, seed):
    got = embed_stub_batch(step, get_config(arch), 2, 16, seed=seed)
    want = r_embed_stub_batch(step, r_get_config(arch), 2, 16, seed=seed)
    assert set(got) == set(want) == {"embeds", "targets"}
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


def _serve_args(arch, *extra):
    return ["--arch", arch, "--preset", "reduced", "--device", "cpu",
            "--slots", "2", "--requests", "3", "--prompt-len", "8",
            "--gen", "4", *extra]


def test_embed_stub_serve_runs_on_the_cpu():
    """musicgen-large reduced through `serve.main`: every request
    completes on seeded pseudo-embeddings (0.02 x normal, the reference's
    scale), the same seed gives the same tokens, another seed others."""
    a = tserve.main(_serve_args("musicgen-large"))
    assert a["completed"] == 3
    assert all(len(r["token_ids"]) == 4 for r in a["per_request"])
    b = tserve.main(_serve_args("musicgen-large"))
    c = tserve.main(_serve_args("musicgen-large", "--seed", "1"))
    toks = [[r["token_ids"] for r in x["per_request"]] for x in (a, b, c)]
    assert toks[0] == toks[1] != toks[2]
    eng = tserve.ServeEngine(build(get_config("musicgen-large").reduced(),
                                   device="cpu"), slots=2, max_len=12)
    req = tserve.ServeRequest(rid=0, prompt_len=4096, gen=1)
    emb = eng._prompt_inputs(req)["embeds"]
    assert emb.shape == (1, 4096, 64) and emb.dtype == torch.float32
    assert abs(float(emb.std()) - 0.02) < 5e-4
    step = eng._step_inputs(torch.zeros(2, dtype=torch.int64), [3, 5], 0)
    assert step["embeds"].shape == (2, 1, 64) and "tokens" not in step
    assert step["positions"].tolist() == [3, 5]


def test_embed_stub_train_cli_runs_on_the_cpu(tmp_path):
    """internvl2-26b reduced through the train CLI: embed_stub_batch feeds
    it; the CLI's default arch is llama3.2-1b, as the reference's."""
    assert ttrain.parse_args([]).arch == "llama3.2-1b"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "internvl2-26b", "--preset", "reduced", "--device", "cpu",
         "--steps", "2", "--batch", "2", "--seq", "16", "--ckpt-dir",
         str(tmp_path)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert any(line.startswith("done: 2 steps") for line in
               out.stdout.splitlines()), out.stdout


# ---------------------------------------------------------------------------
# the serve model's compute-dtype weights
# ---------------------------------------------------------------------------


def _bf16(arch):
    return dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")


def _feed(cfg, t, b=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    if cfg.embed_stub:
        return {"embeds": torch.randn((b, t, cfg.d_model), generator=g)
                * 0.02}
    return {"tokens": torch.randint(0, cfg.vocab_size, (b, t), generator=g)}


def _greedy_logits(model, steps=3):
    cfg = model.cfg
    caches, logits = model.prefill(_feed(cfg, 7), max_len=7 + steps)
    out = [logits]
    for i in range(steps):
        step = _feed(cfg, 1, seed=i + 1) if cfg.embed_stub else \
            {"tokens": logits.argmax(-1)[:, None]}
        step["positions"] = torch.full((2,), 7 + i, dtype=torch.int32)
        caches, logits = model.decode_step(caches, step)
        out.append(logits)
    return torch.stack(out)


@pytest.mark.parametrize("arch", ["gemma-2b", "llama3.2-1b",
                                  "deepseek-v2-lite-16b", "recurrentgemma-9b",
                                  "xlstm-125m", "musicgen-large"])
def test_serving_weights_give_bit_equal_logits(arch):
    """`build(..., for_serving=True)` on a bfloat16 reduced config holds
    every leaf `_compute_cast` converts only in bfloat16, keeps the table,
    head, norms and routers float32, and gives logits equal to the bit to
    the float32-master model from the same seed."""
    cfg = _bf16(arch)
    master = build(cfg, device="cpu", seed=0)
    served = build(cfg, device="cpu", seed=0, for_serving=True)
    for (n, a), (m, b) in zip(master.named_parameters(),
                              served.named_parameters()):
        assert n == m
        leaf = n.rsplit(".", 1)[-1]
        if n.startswith("layers.") and _cast_rule(leaf, a, torch.bfloat16):
            assert b.dtype == torch.bfloat16, n
            assert torch.equal(b, a.to(torch.bfloat16)), n
            assert served._cast(b, leaf) is b
        else:
            assert b.dtype == a.dtype and torch.equal(a, b), n
    assert not served._cast_cache
    torch.testing.assert_close(_greedy_logits(served),
                               _greedy_logits(master), atol=0, rtol=0)


def test_serving_weights_keep_cim_counts_and_tokens():
    """A bfloat16 reduced gemma-2b with the int8 CiM decode: the serving
    model charges the ledger what the float32-master model charges, with
    the same tokens, through the serve engine's repack and resident runs."""
    cfg = with_cim(_bf16("gemma-2b"), 8)
    args = tserve.parse_args(["--preset", "reduced", "--device", "cpu",
                              "--slots", "2", "--requests", "2",
                              "--prompt-len", "8", "--gen", "4",
                              "--cim-lower", "--cim-resident"])
    runs = []
    for serving in (False, True):
        model = build(cfg, device="cpu", seed=0, for_serving=serving)
        tserve.fresh_cim_state()
        rep = tserve.serve_once(model, args)
        runs.append(([r["token_ids"] for r in rep["per_request"]],
                     rep["step_accesses"], rep["step_dispatches"],
                     rep["ledger"]))
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# resident pins
# ---------------------------------------------------------------------------


def _pins_before_the_repair(cfg, slots):
    """`_decode_weight_pins` before this slice: a d_ff-wide MLP counted on
    every non-xLSTM layer."""
    shapes = [(cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)]
    if cfg.gating in ("swiglu", "geglu"):
        shapes.append((cfg.d_model, cfg.d_ff))
    per = [slots * (1 << planner._log2_ceil(k)) * n for k, n in shapes]
    return per * cfg.n_layers


def test_decode_weight_pins_count_only_the_cim_mlps():
    """The fault the repair fixes: for full-width deepseek-v2-lite-16b the
    old rule counted 81 pins of d_ff 1408 on all 27 layers (the 26 MoE
    layers have no MLP on CiM, and layer 0's is 10944 wide), so the largest
    pin it sized the array for had 2^23 words against the real 2^26 (8x
    short). The repaired count is layer 0's three pins at their width; the
    dense configs' counts are unchanged."""
    ds = with_cim(get_config("deepseek-v2-lite-16b"), 8)
    pins = tserve._decode_weight_pins(ds, 2)
    assert pins == [2 * 2048 * 10944, 2 * 16384 * 2048, 2 * 2048 * 10944]
    old = _pins_before_the_repair(ds, 2)
    assert len(old) == 81 and max(old) == 1 << 23
    assert max(pins) == 1 << 26 == 8 * max(old)
    for arch in ("gemma-2b", "recurrentgemma-9b", "llama3.2-1b", "qwen3-14b",
                 "granite-3-8b", "musicgen-large", "internvl2-26b"):
        cfg = with_cim(get_config(arch), 8)
        assert tserve._decode_weight_pins(cfg, 2) == \
            _pins_before_the_repair(cfg, 2), arch
    assert tserve._decode_weight_pins(
        with_cim(get_config("xlstm-125m"), 8), 2) == []


@pytest.mark.parametrize("arch,n_pins,words", [
    ("deepseek-v2-lite-16b", 3, 1 << 24), ("llama3.2-1b", 48, 1 << 23)])
def test_full_width_residency_bookkeeping_new_configs(arch, n_pins, words):
    """Full width, 2 slots, prompt 8 + gen 4, on the CPU (no model): the
    serve array widens the bitlines until the largest decode weight pin
    fills one tile; every pin is one tile on bank 0, and with the KV blocks
    they fit the paper's 1024 rows (768 after the reserve) in both
    packages' own ResidentSet and PagedKV, with no eviction."""
    spec_t = tserve.resident_array_spec(with_cim(get_config(arch), 8), 2, 12)
    assert spec_t == tarray.ArraySpec(bitline_words=words)
    pins = tserve._decode_weight_pins(with_cim(get_config(arch), 8), 2)
    assert len(pins) == n_pins
    for mod_array, mod_paged, cfg in ((rarray, RPaged, r_get_config(arch)),
                                      (tarray, TPaged, get_config(arch))):
        spec = mod_array.ArraySpec(bitline_words=words)
        rs = mod_array.ResidentSet(spec, reserve_rows=spec.rows // 4)
        paged = mod_paged.for_model(cfg, spec=spec, slots=2, max_len=12,
                                    resident_set=rs)
        assert paged.n_blocks == 2
        assert paged.alloc(0, 8) and paged.alloc(1, 8)
        for j, n_words in enumerate(pins):
            assert spec.plan(n_words).n_tiles == 1
            rs.pin(("w", j), argparse.Namespace(n_bits=8, n_words=n_words))
        assert rs.evictions == 0 and len(rs) == n_pins + 2
        assert rs.rows_per_bank() == {0: n_pins * 8 + 16, 1: 16}
    TLEDGER.reset()
    RLEDGER.reset()
