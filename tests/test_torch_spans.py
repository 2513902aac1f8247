"""The port's spans (`repro_torch.spans`): what an untraced span costs,
and what a profiled CiM serve run shows.

Without a profiler `span()` hands back one shared null context and builds
no `record_function`. Under the CPU profiler a tiny CiM engine (reduced
gemma-2b, int8 MLP and decode attention, resident pins, 2 slots x 2
requests, as `test_torch_serve.py::test_serve_engine_tokens_match_reference`
builds the port's side) runs inside the CUDA-graph stand-in, so warm
programs replay: the spans nest as the serve engine, the model, the
lowering compiler, the schedule programs and the graphs call one another,
a warm decode step replays one graph per dispatch, and the profiler moves
no token, ledger access or dispatch count.
"""
import dataclasses

import pytest
import torch

import _torch_stand_in

from repro_torch import spans
from repro_torch.configs.registry import GEMMA_2B as T_GEMMA
from repro_torch.launch import serve as tserve
from repro_torch.models.model import Model, with_cim

#: each span's parents (its nearest `repro.` ancestor), the index of a
#: region dropped
PARENTS = {
    "serve.prefill": {None}, "serve.insert": {None}, "serve.decode": {None},
    "serve.sample": {None},
    "model.mixer": {"serve.prefill", "serve.decode"},
    "model.mlp": {"serve.prefill", "serve.decode"},
    "model.head": {"serve.prefill", "serve.decode"},
    "lower.call": {"model.mixer", "model.mlp"},
    "lower.host": {"lower.call"}, "lower.resident": {"lower.call"},
    "cim.region": {"lower.call"},
    "cim.program": {"cim.region"},
    "graph.copy_in": {"cim.program"}, "graph.replay": {"cim.program"},
    "graph.copy_out": {"cim.program"},
}


def _kind(name):
    """A span's name without `repro.` and a region's index."""
    name = name[len("repro."):]
    return "cim.region" if name.startswith("cim.region.") else name


def _repro_parent(e):
    e = e.cpu_parent
    while e is not None and not e.name.startswith("repro."):
        e = e.cpu_parent
    return e


def _serve(profiled: bool):
    """(report, the profiler's `repro.` events or None) of one fresh run."""
    cfg = dataclasses.replace(with_cim(T_GEMMA.reduced(), 8),
                              cim_resident=True)
    model = Model(cfg, device="cpu", seed=0)
    args = tserve.parse_args(["--preset", "reduced", "--device", "cpu",
                              "--slots", "2", "--requests", "2",
                              "--prompt-len", "4", "--gen", "5",
                              "--cim-lower"])
    tserve.fresh_cim_state()
    with _torch_stand_in.stand_in():
        if not profiled:
            return tserve.serve_once(model, args), None
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            report = tserve.serve_once(model, args)
    return report, [e for e in prof.events() if e.name.startswith("repro.")]


@pytest.fixture(scope="module")
def runs():
    plain = _serve(False)[0]
    report, events = _serve(True)
    tserve.fresh_cim_state()
    return plain, report, events


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name))
    assert not torch.autograd.profiler._is_profiler_enabled
    assert spans.span("repro.serve.decode") is spans._NULL
    assert spans.span("repro.cim.region", 3) is spans._NULL
    with spans.span("repro.lower.host"):
        pass
    assert made == []


def test_a_live_span_joins_its_index():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("repro.cim.region", 3):
            with spans.span("repro.cim.program"):
                torch.zeros(1)
    names = [e.name for e in prof.events()]
    assert "repro.cim.region.3" in names and "repro.cim.program" in names


def test_profiled_engine_takes_the_graph_path(runs):
    _, report, events = runs
    assert report["graphs"]["captured"] > 0
    assert report["graphs"]["replays"] > 0
    assert sum(e.name == "repro.graph.replay" for e in events) \
        == report["graphs"]["replays"]


def test_spans_nest_as_the_layers_call(runs):
    _, _, events = runs
    seen = set()
    for e in events:
        parent = _repro_parent(e)
        kind = _kind(e.name)
        pk = None if parent is None else _kind(parent.name)
        assert pk in PARENTS[kind], (e.name, None if parent is None
                                     else parent.name)
        seen.add(kind)
    assert seen == set(PARENTS)
    # a decode MLP's three products (up, gate, down) and decode
    # attention's two (QK^T, AV) are regions 0-2 and 0-1 of their calls
    regions = {}
    for e in events:
        if _kind(e.name) == "cim.region":
            call = _repro_parent(e)
            model = _kind(_repro_parent(call).name)
            top = _kind(_repro_parent(_repro_parent(call)).name)
            if top == "serve.decode":
                regions.setdefault(model, set()).add(
                    int(e.name.rsplit(".", 1)[1]))
    assert regions == {"model.mlp": {0, 1, 2}, "model.mixer": {0, 1}}


def test_warm_decode_step_replays_a_graph_per_dispatch(runs):
    _, report, events = runs
    steps = sorted((e for e in events if e.name == "repro.serve.decode"),
                   key=lambda e: e.time_range.start)
    assert len(steps) == report["decode_steps"] == 4
    replays = [0] * len(steps)
    index = {id(e): i for i, e in enumerate(steps)}
    for e in events:
        if e.name != "repro.graph.replay":
            continue
        top = e
        while _repro_parent(top) is not None:
            top = _repro_parent(top)
        if id(top) in index:
            replays[index[id(top)]] += 1
    warm = [i for i in range(len(steps))
            if i + 1 not in report["capture_steps"]]
    assert warm, report["capture_steps"]
    for i in warm:
        assert replays[i] == report["step_dispatches"][i] == 10


def test_profiler_moves_no_token_or_count(runs):
    plain, report, _ = runs
    assert [r["token_ids"] for r in report["per_request"]] == \
        [r["token_ids"] for r in plain["per_request"]]
    for key in ("ledger", "step_accesses", "step_dispatches",
                "capture_steps"):
        assert report[key] == plain[key], key
    assert report["graphs"]["replays"] == plain["graphs"]["replays"]
    assert report["graphs"]["captured"] == plain["graphs"]["captured"]
