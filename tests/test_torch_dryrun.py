"""Port vs reference: the dry run and its sweep (`launch/dryrun.py`,
`launch/sweep.py`).

One reduced cell per step kind runs on an 8-rank fake process group (a 4x2
mesh) through `run_cell`: its status, the analytic FLOPs and bytes and
`model_flops` equal the reference's formulas on the reference's reduced
model (parameter and cache bytes equal too), the global figures are the
traced per-partition ones times the ranks against the analytic ones, the
larger kept, and the collectives the step issues are counted (parameter
all-gathers; gradient reduce-scatters and metric all-reduces in training).
A shape the arch does not run is skipped, a failing cell is an error and
the CLI exits 1. The sweep keeps the reference's cell order and skips
cached cells.
"""
import dataclasses
import json
import os

import jax
import pytest

from repro.configs import SHAPES as RSHAPES
from repro.configs import get_config as rget
from repro.launch import roofline as rrl
from repro.launch import sweep as rsweep
from repro.models import build as rbuild
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, sweep

ARCH = "llama3.2-1b"


def _reduced_overrides():
    red = get_config(ARCH).reduced()
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if f.name != "name"}


def _ref_bytes(shape):
    rcfg = rget(ARCH).reduced()
    rmodel = rbuild(rcfg)
    params = jax.eval_shape(rmodel.init, jax.random.PRNGKey(0))
    pb = sum(l.size * l.dtype.itemsize for l in jax.tree.leaves(params))
    cb = 0
    if shape.kind != "train":
        caches = jax.eval_shape(
            lambda: rmodel.init_caches(shape.global_batch, shape.seq_len))
        cb = sum(l.size * l.dtype.itemsize for l in jax.tree.leaves(caches))
    return rcfg, params, float(pb), float(cb)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_reduced_cell_on_eight_fake_ranks(tmp_path, shape):
    res = dryrun.run_cell(ARCH, shape, "4x2", str(tmp_path), force=True,
                          overrides=_reduced_overrides(), mesh_shape=(4, 2))
    assert res.get("status") == "ok", res.get("traceback")
    rshape = RSHAPES[shape]
    rcfg, rparams, pb, cb = _ref_bytes(rshape)
    assert res["n_chips"] == 8 and res["mesh"] == "4x2"
    assert res["params_bytes"] == pb and res["cache_bytes"] == cb
    assert res["model_flops"] == rrl.model_flops(rcfg, rparams, rshape)
    assert res["analytic_flops"] == rrl.analytic_flops(rcfg, rshape)
    assert res["analytic_bytes"] == rrl.analytic_bytes(rcfg, rshape, pb, cb)
    cost, roof = res["cost"], res["roofline"]
    assert cost["flops_per_partition"] > 0 and cost["bytes_per_partition"] > 0
    assert roof["flops_global"] == max(cost["flops_per_partition"] * 8,
                                       res["analytic_flops"])
    assert roof["bytes_global"] == max(cost["bytes_per_partition"] * 8,
                                       res["analytic_bytes"])
    assert roof["device"] == "h100-sxm"
    coll = res["collectives"]
    assert coll["count_by_op"]["all-gather"] > 0
    assert roof["collective_bytes_per_chip"] == \
        sum(coll["bytes_by_op"].values())
    if shape == "train_4k":
        assert coll["count_by_op"]["reduce-scatter"] > 0
        assert coll["count_by_op"]["all-reduce"] > 0
    mem = res["memory"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    assert mem["temp_bytes"] is None
    with open(tmp_path / f"{ARCH}__{shape}__4x2.json") as f:
        assert json.load(f)["roofline"] == roof


def test_traced_decode_flops_are_the_rank_share(tmp_path):
    """A decode step's traced FLOPs: 2 x local rows x the matmul
    parameters (attention's and the MLP's weights, and the head over the
    padded vocab), plus attention over the cache (QK^T and PV), each the
    share of one of the 2 "model" ranks: the projections split by head,
    the MLP by its hidden dim, the head by vocab, decode attention by the
    cache's head_dim. Within 5% of that count for the reduced model."""
    res = dryrun.run_cell(ARCH, "decode_32k", "4x2", str(tmp_path),
                          force=True, overrides=_reduced_overrides(),
                          mesh_shape=(4, 2))
    cfg = get_config(ARCH).reduced()
    rows = RSHAPES["decode_32k"].global_batch // 4
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    per_layer = d * (h + 2 * kv) * hd + h * hd * d + 3 * d * cfg.d_ff
    matmul = cfg.n_layers * per_layer + d * cfg.vocab_padded
    attn = cfg.n_layers * 2 * h * hd * RSHAPES["decode_32k"].seq_len
    want = 2.0 * rows * (matmul + attn) / 2
    got = res["cost"]["flops_per_partition"]
    assert abs(got - want) / want < 0.05, (got, want)


def test_long_context_cell_is_skipped_for_full_attention(tmp_path):
    res = dryrun.run_cell(ARCH, "long_500k", "single", str(tmp_path),
                          force=True)
    assert "skipped" in res and "status" not in res


def test_failing_cell_is_an_error_and_the_cli_exits_1(tmp_path, capsys):
    res = dryrun.run_cell(ARCH, "decode_32k", "4x2", str(tmp_path),
                          force=True, overrides={"n_kv_heads": 3},
                          mesh_shape=(4, 2))
    assert res["status"] == "error" and "Traceback" in res["traceback"]
    assert dryrun.main(["--arch", "no-such-arch", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 1
    with open(tmp_path / "no-such-arch__decode_32k__single.json") as f:
        assert json.load(f)["status"] == "error"


def test_sweep_keeps_the_reference_cell_order():
    for meshes in (["single"], ["multi"], ["single", "multi"]):
        assert list(sweep.cells(meshes)) == list(rsweep.cells(meshes))
    assert sweep.ARCH_COST == rsweep.ARCH_COST
    assert sweep.SHAPE_COST == rsweep.SHAPE_COST


def test_sweep_skips_cached_cells_and_reruns_failed_ones(tmp_path,
                                                         monkeypatch):
    out = str(tmp_path)
    cells = list(sweep.cells(["single"]))
    for i, (arch, shape, mesh) in enumerate(cells):
        status = ({"status": "error"} if i == 3 else
                  {"skipped": "x"} if i % 2 else {"status": "ok"})
        with open(os.path.join(out, f"{arch}__{shape}__{mesh}.json"),
                  "w") as f:
            json.dump({"arch": arch, **status}, f)
    ran = []

    class Done:
        returncode = 0

    def fake_run(cmd, **kw):
        ran.append(cmd)
        return Done()
    monkeypatch.setattr(sweep.subprocess, "run", fake_run)
    assert sweep.run(out, ["single"]) == 0
    assert len(ran) == 1
    arch, shape, _ = cells[3]
    assert ran[0][4:] == ["repro_torch.launch.dryrun", "--arch", arch,
                          "--shape", shape, "--mesh", "single", "--out",
                          out, "--force"]
