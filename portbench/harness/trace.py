"""The traced run's profiler window and its reduction.

With `--trace 1`, `torch.profiler` traces the host and the card for
`trace_seconds` (a traffic file's key; stopped at the first token that
comes out after them) from the end of the window's first decode step, so
after the burst of prefills that opens a window, and the benchmark's own
spans (`bench.prefill`, `bench.insert`, `bench.decode`, `bench.sample`)
mark what the host was doing. The reduction gives the
device time of every operation by name, the seconds in which any device
operation ran (`busy_s`, the union of their intervals), the traced
window's length, the longest idle gaps named by the benchmark span around
them, and the program counters' change over the traced window.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Optional

import torch


def _is_work(e, name: str) -> bool:
    """A device event that is work (a kernel, a copy or a fill), not the
    device-side copy of a host annotation (named as the annotation)."""
    if name.startswith("bench."):
        return False
    ann = getattr(e, "is_user_annotation", None)
    return not (ann is not None and ann())


def _span_ns(e):
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.duration_ns()
    return int(e.start_us() * 1000), int(e.duration_us() * 1000)


class Tracer:
    def __init__(self, enabled: bool, seconds: float, device: torch.device,
                 counters: Optional[Callable[[], Dict[str, float]]] = None):
        self.enabled, self.seconds, self.device = enabled, seconds, device
        self.counters = counters or (lambda: {})
        self.prof = None
        self.running = False
        self.window_s = 0.0
        self.c0: Dict[str, float] = {}
        self.c1: Dict[str, float] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        if not self.enabled:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self._sync()
        self.prof.start()
        self.c0 = self.counters()
        self.t0 = time.perf_counter()
        self.running = True

    def tick(self) -> None:
        """Stop once the traced seconds have passed."""
        if self.running and time.perf_counter() - self.t0 >= self.seconds:
            self.stop()

    def stop(self) -> None:
        if not self.running:
            return
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.c1 = self.counters()
        self.prof.stop()
        self.running = False

    def span(self, name: str):
        if not self.running:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench.{name}")

    def summary(self) -> Optional[Dict[str, Any]]:
        if self.prof is None:
            return None
        return reduce_events(self.prof.profiler.kineto_results.events(),
                             self.window_s,
                             {k: self.c1.get(k, 0) - v
                              for k, v in self.c0.items()})


def reduce_events(events, window_s: float,
                  counters: Dict[str, float]) -> Dict[str, Any]:
    """Device time by operation name, busy seconds, idle gaps named by the
    benchmark span covering their middle, from the profiler's raw events."""
    dev: List[tuple] = []
    spans: List[tuple] = []
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if _is_work(e, name):
                s, d = _span_ns(e)
                dev.append((s, s + d, name))
        elif name.startswith("bench."):
            s, d = _span_ns(e)
            spans.append((s, s + d, name[6:]))
    by_name: Dict[str, float] = {}
    for s, t, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (t - s) * 1e-9
    dev.sort()
    busy_ns = 0
    gaps: List[tuple] = []
    cur_s = cur_t = None
    for s, t, _ in dev:
        if cur_t is None:
            cur_s, cur_t = s, t
        elif s > cur_t:
            busy_ns += cur_t - cur_s
            gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy_ns += cur_t - cur_s
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:10]:
        mid = (g0 + g1) // 2
        around = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        label = min(around, key=lambda sp: sp[1] - sp[0])[2] if around \
            else "host"
        named.append([label, (g1 - g0) * 1e-9])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_ns * 1e-9, "window_s": window_s,
            "kernels": by_name, "counters": counters,
            "device_ops": [[n[:200], v] for n, v in top],
            "idle_gaps": named}


def kernel_seconds(trace: Optional[Dict[str, Any]], match: str) -> float:
    """Device seconds of the traced operations whose name holds `match`."""
    if not trace:
        return 0.0
    return sum(v for n, v in trace["kernels"].items() if match in n)
