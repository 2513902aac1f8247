"""A whole run on the CPU at a tiny size (the card's look skipped): the
metrics a cell reports, and `correct` coming out false when the timed path
is broken underneath, once for each fault a serve cell can have."""
import time

import pytest
import torch

import tiny
from portbench import run
from portbench.harness import common

CIM_CELL = "granite-3-8b-stage.cim-decode"
#: a float-path cell as a later entry of BENCHMARK.json would add it: the
#: float traffic, its tail and its copy and cast shares (`_bench`)
FLOAT_CELL = "tiny-moe.float-decode"
CELLS = {CIM_CELL: {"rounds_per_s": 0.0,
                    "limits": {"widest_gap": 0.05, "step_access_gap": 0,
                               "step_dispatch_gap": 0}},
         FLOAT_CELL: {"rounds_per_s": 0.0, "limits": {"mean_gap": 0.01}}}
#: the float cell's configuration is a dropless MoE with MLA
CASES = {CIM_CELL: ("dense", "cim"), FLOAT_CELL: ("dropless", "float")}


def _bench():
    """BENCHMARK.json with the float cell and its metrics added."""
    bench = common.load_benchmark()
    bench["workloads"].append({"name": FLOAT_CELL, "config": "tiny-moe",
                               "traffic": "float-decode", "chips": 1})
    for m in bench["end_to_end"]:
        if m["name"] == "output_tok_s":
            m["workloads"].append(FLOAT_CELL)
    bench["end_to_end"].append({"name": "tpot_p95_ms", "unit": "ms",
                                "workloads": [FLOAT_CELL]})
    for name in ("cast_share", "copy_share"):
        bench["per_layer"].append({"name": name, "unit": "%",
                                   "moves": "output_tok_s",
                                   "workloads": [FLOAT_CELL]})
    return bench


def _evaluate(cell, trace=False):
    family, path = CASES[cell]
    cfg = tiny.dropless_moe() if family == "dropless" else tiny.get(family)
    return run.evaluate(_bench(), cell, cfg,
                        tiny.get(path), CELLS[cell], 987654321987, 0.0,
                        trace, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("cell", [CIM_CELL, FLOAT_CELL])
def test_sound_run_is_correct(cell):
    result, checks, rec = _evaluate(cell)
    assert result["correct"], checks
    names = set(result["metrics"])
    assert {"output_tok_s", "setup_s"} <= names
    assert ("tpot_p95_ms" in names) == (cell == FLOAT_CELL)
    assert result["failed"] == 0 and result["attempted"] == 2 + 2 * (
        cell == FLOAT_CELL)


@pytest.mark.parametrize("cell", [CIM_CELL, FLOAT_CELL])
def test_traced_run_reports_per_layer_metrics(cell):
    result, _, _ = _evaluate(cell, trace=True)
    names = set(result["metrics"])
    assert {"decode_step_ms_p50", "prefill_ms_mean"} <= names
    # the CPU has no peak in the table: no share of one
    assert "decode_mfu" not in names
    if cell == CIM_CELL:
        assert {"cim_accesses_per_token", "cim_dispatches_per_token"} <= names
    # the CPU has no device trace: those readers return nothing
    assert "device_idle_share.decode" not in names \
        or result["device"]["platform"] == "gpu"
    assert "breakdown" in result


def _altered_sample(monkeypatch):
    """Sampling that serves a wrong token in slot 0 at every decode step
    after the warm-up requests' two."""
    from repro_torch.launch import serve as S

    calls = {"n": 0}
    real = S.greedy_sample

    def sample(logits):
        tok = real(logits)
        if logits.shape[0] > 1:
            calls["n"] += 1
            if calls["n"] > 2:
                tok = tok.clone()
                tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok
    monkeypatch.setattr(S, "greedy_sample", sample)


def _state_unchanged(monkeypatch):
    """A decode step that returns its caches unchanged."""
    from repro_torch.launch import serve as S

    def make_decode_step(model):
        def decode(caches, inputs):
            _, logits = model.decode_step(caches, inputs)
            return caches, logits
        return decode
    monkeypatch.setattr(S, "make_decode_step", make_decode_step)


@pytest.mark.parametrize("cell", [CIM_CELL, FLOAT_CELL])
@pytest.mark.parametrize("fault", [_altered_sample, _state_unchanged])
def test_broken_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    result, checks, _ = _evaluate(cell)
    assert not result["correct"], checks
