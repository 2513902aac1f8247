"""The program's own spans in a traced run, tied to device time.

The port marks its layer boundaries with `repro.<layer>.<what>` spans
(`repro_torch/spans.py`), recorded by the same profiler as the device
operations, so both share its clock. `reduce_spans` links each device
operation (a kernel, a copy or a fill) to the host call that launched it by
the profiler's correlation ids and names it by the path of `repro.` spans
around that launch on its thread (for example
`serve.decode/model.mlp/lower.call/cim.region.2/cim.program/graph.replay`;
a graph's kernels all link to its one `cudaGraphLaunch`). It gives:

- `spans`: for each path, its calls, host seconds, host self seconds (less
  its child spans'), device self seconds (the operations launched with
  that path innermost) and their seconds by operation name, largest first;
- `attributed_s`: the device seconds that landed on a path;
- `decode_enqueue_ms`: for each `repro.serve.decode`, the host
  milliseconds from its start to the end of the last call inside it that
  launched a device operation;
- `idle_gaps`: the ten longest gaps with no device operation, as
  `trace.reduce_events` finds and names them, each named `<bench
  span>/<innermost repro span>` where a program span covers its middle;
- `links`: how many device operations linked to a runtime call, to the
  host op around the launch alone, or to nothing.

Without any `repro.` span (a program that has none) `spans` is empty,
`idle_gaps` is `trace.reduce_events`'s, and the shares below give None.

How a device operation finds its launch: its `correlation_id()` is that of
the runtime call that launched it (`cudaLaunchKernel`, `cudaGraphLaunch`,
`cudaMemcpyAsync`, ...), which dates the launch, and its
`linked_correlation_id()` the id of the innermost aten op around the
launch, which gives the thread the program's spans are on and dates the
launch where no runtime call was traced. A span is no such op: a graph
launched inside `repro.graph.replay` alone links to its `cudaGraphLaunch`
and not to the span (torch 2.11 on the H100), so the runtime call's own
thread places it.
"""
from __future__ import annotations

import statistics
from typing import Any, Dict, List, Optional, Tuple

import torch

from .trace import _is_work, _span_ns

PREFIX = "repro."


def reduce_spans(events) -> Dict[str, Any]:
    """The span keys of a traced run, from the profiler's raw events."""
    dev: List[Tuple[int, int, str]] = []
    dev_ids: List[Tuple[int, int]] = []
    spans: Dict[int, List[Tuple[int, int, str]]] = {}
    bench: List[Tuple[int, int, str]] = []
    ops: Dict[int, Tuple[int, int, int]] = {}
    runtime: Dict[int, Tuple[int, int, int]] = {}
    for e in events:
        name = e.name()
        s, d = _span_ns(e)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if _is_work(e, name) and not name.startswith(PREFIX):
                dev.append((s, s + d, name))
                dev_ids.append((e.correlation_id(),
                                e.linked_correlation_id()))
            continue
        if name.startswith(PREFIX):
            spans.setdefault(e.start_thread_id(), []).append(
                (s, s + d, name))
        elif name.startswith("bench."):
            bench.append((s, s + d, name[6:]))
        if _is_runtime(e, name):
            runtime[e.correlation_id()] = (s, s + d, e.start_thread_id())
        else:                                  # a host op or a span
            ops.setdefault(e.correlation_id(),
                           (s, s + d, e.start_thread_id()))

    links = {"runtime": 0, "op": 0, "none": 0}
    launches: Dict[int, List[Tuple[int, int, int]]] = {}   # thread ->
    for i, (corr, linked) in enumerate(dev_ids):
        op = ops.get(linked) if linked > 0 else None
        rt = runtime.get(corr)
        if rt is None and op is None:
            links["none"] += 1
            continue
        links["runtime" if rt is not None else "op"] += 1
        s, t, thread = rt if rt is not None else op
        launches.setdefault(op[2] if op else thread, []).append((s, t, i))

    table: Dict[str, Dict[str, Any]] = {}
    paths: List[Optional[str]] = [None] * len(dev)
    enqueue: List[float] = []
    for thread, sp in spans.items():
        enqueue += _sweep(sorted(sp, key=lambda x: (x[0], -x[1])),
                          sorted(launches.get(thread, ())), table, paths)

    attributed = 0.0
    for (s, t, name), path in zip(dev, paths):
        if path is not None:
            row = table[path]
            row["device_s"] += (t - s) * 1e-9
            row["kernels"][name] = row["kernels"].get(name, 0.0) \
                + (t - s) * 1e-9
            attributed += (t - s) * 1e-9
    for row in table.values():
        row["kernels"] = dict(sorted(row["kernels"].items(),
                                     key=lambda kv: -kv[1]))
    return {"spans": table, "attributed_s": attributed,
            "decode_enqueue_ms": enqueue, "links": links,
            "idle_gaps": _gaps(dev, bench,
                               [x for sp in spans.values() for x in sp])}


def _is_runtime(e, name: str) -> bool:
    """A CUDA runtime or driver call (its correlation id is the device
    operation's, not a host op's)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in ("cuda_runtime", "cuda_driver")
    return e.linked_correlation_id() > 0 or name.startswith("cu")


def _sweep(sp, queries, table, paths) -> List[float]:
    """One thread's spans (by start, outer first) and launches (by time):
    each span's row of `table`, each launch's innermost path into `paths`;
    returns the enqueue milliseconds of each `serve.decode` that launched
    anything."""
    stack: List[list] = []          # [start, end, path, last launch end]
    decodes: List[list] = []
    qi = 0

    def settle(time):
        while stack and stack[-1][1] < time:
            stack.pop()

    def answer(limit):
        nonlocal qi
        while qi < len(queries) and queries[qi][0] < limit:
            tq, end, i = queries[qi]
            settle(tq)
            if stack:
                paths[i] = stack[-1][2]
                stack[0][3] = max(stack[0][3] or end, end)
            qi += 1

    for s, t, name in sp:
        answer(s)
        settle(s)
        parent = stack[-1][2] if stack else None
        path = (parent + "/" if parent else "") + name[len(PREFIX):]
        if parent is not None:
            table[parent]["host_self_s"] -= (t - s) * 1e-9
        row = table.setdefault(path, {"calls": 0, "host_s": 0.0,
                                      "host_self_s": 0.0, "device_s": 0.0,
                                      "kernels": {}})
        row["calls"] += 1
        row["host_s"] += (t - s) * 1e-9
        row["host_self_s"] += (t - s) * 1e-9
        entry = [s, t, path, None]
        stack.append(entry)
        if path == "serve.decode":
            decodes.append(entry)
    answer(float("inf"))
    return [(last - s) * 1e-6 for s, _, _, last in decodes
            if last is not None]


def _gaps(dev, bench, spans) -> List[list]:
    """`trace.reduce_events`'s ten longest idle gaps, their names followed
    by the innermost program span covering their middle, if one does."""
    gaps: List[tuple] = []
    cur_t = None
    for s, t, _ in sorted(dev):
        if cur_t is not None and s > cur_t:
            gaps.append((cur_t, s))
        cur_t = t if cur_t is None else max(cur_t, t)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:10]:
        mid = (g0 + g1) // 2
        around = [sp for sp in bench if sp[0] <= mid <= sp[1]]
        label = min(around, key=lambda sp: sp[1] - sp[0])[2] if around \
            else "host"
        inner = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        if inner:
            label += "/" + min(inner, key=lambda sp: sp[1] - sp[0])[2][
                len(PREFIX):]
        named.append([label, (g1 - g0) * 1e-9])
    return named


# ---------------------------------------------------------------------------
# the shares a traced CiM decode run reads from them (None without spans)
# ---------------------------------------------------------------------------


def _device_s(trace, keep) -> Optional[float]:
    if not trace or not trace.get("spans") or trace["busy_s"] <= 0:
        return None
    return sum(row["device_s"] for path, row in trace["spans"].items()
               if keep(path.split("/")))


def packed_glue_share(trace) -> Optional[float]:
    """Device time replayed from the schedule programs' graphs, less the
    fused bit-plane kernel's, over busy: the packed-domain glue (%)."""
    t = _device_s(trace, lambda p: p[-1] == "graph.replay")
    if t is None:
        return None
    fused = sum(v for path, row in trace["spans"].items()
                if path.endswith("graph.replay")
                for n, v in row["kernels"].items() if "fused_planes" in n)
    return 100.0 * (t - fused) / trace["busy_s"]


def float_ops_share(trace) -> Optional[float]:
    """Device time inside decode steps outside every schedule program, over
    busy: the float model and the lowered functions' host nodes (%)."""
    t = _device_s(trace, lambda p: p[0] == "serve.decode"
                  and "cim.program" not in p)
    return None if t is None else 100.0 * t / trace["busy_s"]


def program_copy_share(trace) -> Optional[float]:
    """Device time in the graphs' input copies and output clones, over
    busy (%)."""
    t = _device_s(trace, lambda p: p[-1] in ("graph.copy_in",
                                             "graph.copy_out"))
    return None if t is None else 100.0 * t / trace["busy_s"]


def decode_enqueue_ms_p50(trace) -> Optional[float]:
    """Median host milliseconds a decode step takes to issue its device
    work."""
    if not trace or not trace.get("spans") or not trace["decode_enqueue_ms"]:
        return None
    return statistics.median(trace["decode_enqueue_ms"])


SHARES = {"packed_glue_share": packed_glue_share,
          "float_ops_share": float_ops_share,
          "program_copy_share": program_copy_share,
          "decode_enqueue_ms_p50": decode_enqueue_ms_p50}
