"""The program spans' reduction (`harness/spans.py`) on synthetic profiler
events: a launch inside nested spans, a graph's kernels behind one launch,
a kernel outside every span, idle gaps named with and without a program
span, a trace without program spans (the benchmark's reduction unchanged),
and the four shares read from a reduced trace."""
import pytest
import torch

from portbench import span_table
from portbench.harness import spans
from portbench.harness.trace import reduce_events

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class _Ev:
    """A raw profiler event with its correlation ids: a host op or span
    (its own id, linked 0), a runtime call (the device operation's id,
    linked to the host op around it) or a device operation."""

    def __init__(self, name, start, dur, cuda=False, corr=0, linked=0,
                 kind=None, thread=7):
        self._n, self._s, self._d = name, start, dur
        self._dev = CUDA if cuda else CPU
        self._corr, self._linked, self._thread = corr, linked, thread
        self._kind = kind or ("kernel" if cuda else "cpu_op")

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._kind in ("user_annotation", "gpu_user_annotation")

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def start_thread_id(self):
        return self._thread

    def activity_type(self):
        return self._kind


@pytest.fixture(autouse=True, params=["activity_type", "torch 2.11"])
def _events_as(request, monkeypatch):
    """Every case twice: with each event's activity type, and without it,
    as torch 2.11's `_KinetoEvent` gives them (runtime calls then known
    by their names)."""
    if request.param != "activity_type":
        monkeypatch.delattr(_Ev, "activity_type")


def _span(name, start, dur, corr):
    return _Ev(name, start, dur, corr=corr, kind="user_annotation")


def _launch(op_name, op_id, start, dev_corr, kernels, api="cudaLaunchKernel"):
    """A host op at `start` (10 ns) whose runtime call launches `kernels`
    [(name, start, dur)] under one correlation id."""
    return [_Ev(op_name, start, 10, corr=op_id),
            _Ev(api, start + 2, 5, corr=dev_corr, linked=op_id,
                kind="cuda_runtime")] + [
        _Ev(n, s, d, cuda=True, corr=dev_corr, linked=op_id)
        for n, s, d in kernels]


def _decode_step():
    """One decode step: an MLP whose region runs as a replayed graph (two
    kernels behind one cudaGraphLaunch, linked to no host op, as on the
    card: a span is none) after a copy into its inputs, then a float op in
    the head. Device time: copy [300, 320), fused [320,
    420), reduce [430, 480), gemv [720, 760)."""
    return ([_span("repro.serve.decode", 0, 1000, 1),
             _span("repro.model.mlp", 100, 480, 2),
             _span("repro.lower.call", 110, 460, 3),
             _span("repro.cim.region.2", 120, 400, 4),
             _span("repro.cim.program", 130, 380, 5),
             _span("repro.graph.copy_in", 140, 30, 6),
             _span("repro.graph.replay", 200, 50, 7),
             _span("repro.model.head", 700, 200, 9),
             _Ev("bench.decode", 0, 1000, corr=10, kind="user_annotation")]
            + _launch("aten::copy_", 11, 150, 5001, [("copy_kernel", 300, 20)])
            + [_Ev("cudaGraphLaunch", 210, 20, corr=5002,
                   kind="cuda_runtime"),
               _Ev("fused_planes_kernel<4>", 320, 100, cuda=True, corr=5002),
               _Ev("reduce_kernel<int>", 430, 50, cuda=True, corr=5002)]
            + _launch("aten::mm", 12, 710, 5003, [("gemv", 720, 40)]))

REPLAY = ("serve.decode/model.mlp/lower.call/cim.region.2/cim.program/"
          "graph.replay")


def test_a_kernel_launched_inside_nested_spans():
    tr = spans.reduce_spans(_decode_step())
    head = tr["spans"]["serve.decode/model.head"]
    assert head["calls"] == 1 and head["device_s"] == pytest.approx(40e-9)
    assert head["kernels"] == {"gemv": pytest.approx(40e-9)}
    copy = tr["spans"][REPLAY.replace("replay", "copy_in")]
    assert copy["device_s"] == pytest.approx(20e-9)
    # the step's own time less its two children's
    top = tr["spans"]["serve.decode"]
    assert top["host_s"] == pytest.approx(1000e-9)
    assert top["host_self_s"] == pytest.approx(320e-9)
    assert top["device_s"] == 0.0
    assert tr["links"] == {"runtime": 4, "op": 0, "none": 0}
    # the last launching call (the head's) ends at 712 + 5 ns
    assert tr["decode_enqueue_ms"] == [pytest.approx(717e-6)]


def test_a_graphs_kernels_link_to_its_one_launch():
    tr = spans.reduce_spans(_decode_step())
    replay = tr["spans"][REPLAY]
    assert replay["calls"] == 1
    assert replay["device_s"] == pytest.approx(150e-9)
    assert list(replay["kernels"]) == ["fused_planes_kernel<4>",
                                       "reduce_kernel<int>"]
    assert tr["attributed_s"] == pytest.approx(210e-9)


def test_a_kernel_without_a_span_stays_unattributed():
    ev = _decode_step() + _launch("aten::add", 13, 1100, 5004,
                                  [("add_kernel", 1200, 30)]) + [
        _Ev("orphan", 1300, 10, cuda=True, corr=5005, linked=0)]
    tr = spans.reduce_spans(ev)
    assert tr["attributed_s"] == pytest.approx(210e-9)
    assert tr["links"] == {"runtime": 5, "op": 0, "none": 1}
    assert not any("add_kernel" in row["kernels"]
                   for row in tr["spans"].values())


def test_a_launch_without_its_runtime_call_dates_by_its_host_op():
    ev = [e for e in _decode_step() if e.correlation_id() != 5001
          or e.device_type() == CUDA]
    tr = spans.reduce_spans(ev)
    assert tr["links"] == {"runtime": 3, "op": 1, "none": 0}
    assert tr["spans"][REPLAY.replace("replay", "copy_in")]["device_s"] \
        == pytest.approx(20e-9)


def test_a_graph_without_its_launch_is_unattributed():
    ev = [e for e in _decode_step() if e.name() != "cudaGraphLaunch"]
    tr = spans.reduce_spans(ev)
    assert tr["links"] == {"runtime": 2, "op": 0, "none": 2}
    assert REPLAY not in tr["spans"] or tr["spans"][REPLAY]["device_s"] == 0
    assert tr["attributed_s"] == pytest.approx(60e-9)


def test_gaps_are_named_by_the_program_span_over_them():
    # gaps [480, 720) (middle 600: in serve.decode alone), [420, 430)
    # (middle 425: in cim.program) and, with a late kernel, [760, 1400)
    # (middle 1080: under no span)
    ev = _decode_step() + [_Ev("late", 1400, 10, cuda=True, corr=9)]
    assert reduce_events(ev, 1e-6, {})["idle_gaps"] == [
        ["host", pytest.approx(640e-9)], ["decode", pytest.approx(240e-9)],
        ["decode", pytest.approx(10e-9)]]
    assert spans.reduce_spans(ev)["idle_gaps"] == [
        ["host", pytest.approx(640e-9)],
        ["decode/serve.decode", pytest.approx(240e-9)],
        ["decode/cim.program", pytest.approx(10e-9)]]


def test_without_program_spans_the_benchmark_reduction_is_unchanged():
    ev = [e for e in _decode_step() if not e.name().startswith("repro.")]
    ev += [_Ev("repro.graph.replay", 320, 160, cuda=True,
               kind="gpu_user_annotation")]
    plain = reduce_events(ev, 1e-6, {"fused_bytes": 1})
    merged = dict(plain)
    merged.update(spans.reduce_spans(ev))
    assert {k: merged[k] for k in plain} == plain
    assert merged["spans"] == {} and merged["attributed_s"] == 0.0
    assert merged["decode_enqueue_ms"] == []
    assert all(f(merged) is None for f in spans.SHARES.values())


def test_a_program_spans_device_copy_is_not_work():
    # named as the span, whether or not the profiler marks it an annotation
    ev = _decode_step() + [_Ev("repro.graph.replay", 320, 160, cuda=True)]
    tr = spans.reduce_spans(ev)
    assert tr["attributed_s"] == pytest.approx(210e-9)
    assert tr["idle_gaps"] == spans.reduce_spans(_decode_step())["idle_gaps"]


def _reduced():
    tr = reduce_events(_decode_step(), 1e-6, {})
    tr.update(spans.reduce_spans(_decode_step()))
    return tr


def test_shares_of_a_reduced_trace():
    tr = _reduced()
    busy = tr["busy_s"]
    assert busy == pytest.approx(210e-9)
    assert spans.packed_glue_share(tr) == pytest.approx(100 * 50e-9 / busy)
    assert spans.float_ops_share(tr) == pytest.approx(100 * 40e-9 / busy)
    assert spans.program_copy_share(tr) == pytest.approx(100 * 20e-9 / busy)
    tr["decode_enqueue_ms"] = [3.0, 1.0, 2.0]
    assert spans.decode_enqueue_ms_p50(tr) == 2.0


def test_parts_of_the_window_add_up():
    tr = _reduced()
    parts = span_table.parts(tr)
    assert parts["fused"] == pytest.approx(100 * 100e-9 / 210e-9)
    assert parts["packed_glue"] + parts["fused"] \
        + parts["graph_copies"] + parts["decode_float"] \
        == pytest.approx(100 * sum(tr["kernels"].values()) / tr["busy_s"])
    assert parts["unattributed"] == pytest.approx(0.0)
    assert span_table.replays_per_decode(tr) == 1.0
