"""A CUDA graph's contract on the CPU, for the port's program tests.

Inside `stand_in()`, programs on CPU tensors take the graph path:
`dispatch._graph_device` names the CPU, and `dispatch._record` captures
the body by running it once under `dispatch.CaptureGuard` (so every body
captured here passes the checks a CUDA capture makes) into a
`StandInGraph`, whose replay recomputes the captured body on its static
inputs into its static outputs and, like a real replay, runs no Python
side effect (the counters its rerun bumps are set back). As a CUDA
capture writes nothing, the capture's writes into its leaves (a donated
state's update) are set back, so the step is applied once, by the replay
that follows the capture. Used by
`test_torch_graphs.py` and by the gloo ranks of `_torch_gloo_ranks.py`
(their collectives run in the capture and in every replay, as a CUDA
graph replays its NCCL kernels).
"""
import contextlib

import torch

from repro_torch.cim import dispatch as tdisp


class StandInGraph:
    """A CUDA graph's contract on the CPU: `replay` recomputes the captured
    body on its static inputs into its static outputs and leaves every
    counter as it found it (a replay runs no Python)."""

    def __init__(self, fn, args, out):
        self.fn, self.args = fn, args
        self.outputs = []
        tdisp._flatten(out, self.outputs)

    def replay(self):
        before = tdisp._counters()
        fresh = []
        tdisp._CAPTURING = True          # programs inside: part of the graph
        try:
            tdisp._flatten(self.fn(*self.args), fresh)
        finally:
            tdisp._CAPTURING = False
        after = tdisp._counters()
        tdisp._add_counters(tuple(b - a for a, b in zip(after, before)))
        for o, f in zip(self.outputs, fresh):
            if o is not f:
                o.copy_(f)


@contextlib.contextmanager
def stand_in():
    """Programs on CPU tensors take the graph path, captured (under the
    capture guard) into stand-in graphs; yields the list of captures."""
    graphs = []

    def record(fn, args, device):
        assert device == torch.device("cpu")
        # a capture runs nothing: what the body writes into its leaves (a
        # donated state) is set back, so only the replays write it
        leaves = []
        tdisp._flatten(args, leaves)
        saved = [tdisp._local(t).clone() for t in leaves]
        tdisp._CAPTURING = True
        try:
            with tdisp.CaptureGuard():
                out = fn(*args)
        finally:
            tdisp._CAPTURING = False
            with torch.no_grad():
                for t, v in zip(leaves, saved):
                    tdisp._local(t).copy_(v)
        graphs.append(StandInGraph(fn, args, out))
        return graphs[-1], out

    def graph_device(tensors):
        return None if tdisp._EAGER or not tensors else torch.device("cpu")

    saved = tdisp._record, tdisp._graph_device
    tdisp._record, tdisp._graph_device = record, graph_device
    try:
        yield graphs
    finally:
        tdisp._record, tdisp._graph_device = saved
