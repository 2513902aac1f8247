"""Named spans at the layer boundaries of the port, for `torch.profiler`.

`span(name)` marks a region of host time: under a running profiler it is
`torch.profiler.record_function(name)`, so the span lands in the trace on
the profiler's clock, beside the device operations launched inside it (the
profiler links each to the innermost host op around its launch). With no
profiler running it reads one flag and returns a shared null context, so
an untraced call costs a function call and an attribute read. The
profiler is the only sink: there is no switch and no exporter.

Every span of the port is named `repro.<layer>.<what>` and goes through
this function. A name built per call (a region's index) is passed as
`index` and joined only when the span is live.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()


def span(name: str, index: Optional[int] = None):
    """A context manager that records `name` (`name.index` with an index)
    while a profiler runs, and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return torch.profiler.record_function(
        name if index is None else f"{name}.{index}")
