"""Geometry/bits autotuner: search the array configuration per region.

Port of `repro.cim.autotune`. For one lowered workload, `Autotuner.tune`
searches tile shape (subarrays x bitline words) x bank count x sensing
scheme [x n_bits via a `build` callback], PRUNED by the cost model
(repro_torch.cim.cost) and CONFIRMED by steady-state walltime measurement
(every call synchronized with the device of its results, the reference's
block-until-ready convention, so a CUDA call times the fused kernel's work
and not its launch):

  1. predict — every candidate's total CiM EDP under `policy="always"`
     (all eligible eqns counted, so geometries compare on the full
     lowering); candidates predicted WORSE than the default geometry are
     never measured. The default itself is always kept, so the tuned
     winner can never regress it.
  2. measure — one representative per distinct execution geometry (the
     sensing scheme changes energy accounting, not execution, so the
     scheme dimension is resolved purely by prediction); winner is the
     lowest measured walltime, ties broken by predicted EDP.

Winners live in a bounded LRU (`repro_torch.cim.dispatch.BoundedLRU` — the same
policy as the compiled-schedule program table) keyed like the dispatch
cache: the STRUCTURAL region keys of the default-geometry lowering x the
`DeviceSpec` identity. A warm key returns its winner with ZERO
re-searches (`Autotuner.searches` counts real searches), and the table
round-trips to JSON so CI and serve can warm-start.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import cost as cost_mod
from .array import ArraySpec
from .dispatch import BoundedLRU

# ---------------------------------------------------------------------------
# search space
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the search space. `n_bits` only takes effect through a
    `build` callback (quantization width changes the traced function);
    without one it is ignored."""

    banks: int = 4
    subarrays: int = 4
    bitline_words: int = 1024
    rows: int = 1024
    scheme: str = "current"
    n_bits: Optional[int] = None

    def spec(self) -> ArraySpec:
        return ArraySpec(banks=self.banks, subarrays=self.subarrays,
                         rows=self.rows, bitline_words=self.bitline_words)

    def geom_key(self, with_bits: bool) -> Tuple:
        """Execution identity: candidates sharing it run bit-identically
        (the sensing scheme is an accounting overlay)."""
        key = (self.banks, self.subarrays, self.bitline_words, self.rows)
        return key + (self.n_bits,) if with_bits else key


#: the hand-picked spec the rest of the repo defaults to
DEFAULT_CANDIDATE = Candidate()

#: a modest default grid (callers with a budget pass their own)
DEFAULT_CANDIDATES: Tuple[Candidate, ...] = tuple(
    Candidate(banks=b, subarrays=s, bitline_words=w, scheme=sc)
    for b in (2, 4, 8)
    for s, w in ((2, 1024), (4, 256), (4, 1024))
    for sc in ("current", "scheme2"))


# ---------------------------------------------------------------------------
# steady-state timing (the kernel_bench block-until-ready convention)
# ---------------------------------------------------------------------------


def _block(x) -> None:
    """Wait for the device work behind `x`: one `torch.cuda.synchronize()`
    per CUDA device its tensors live on (CPU results are ready)."""
    devices = set()

    def visit(t):
        if isinstance(t, torch.Tensor):
            if t.is_cuda:
                devices.add(t.device)
        elif isinstance(t, dict):
            for v in t.values():
                visit(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                visit(v)
        elif hasattr(t, "planes"):          # a PlanePack
            visit(t.planes)
    visit(x)
    for dev in devices:
        torch.cuda.synchronize(dev)


def steady_ms(fn: Callable[[], object], n: int = 5) -> float:
    """Mean wall ms per call after a capture/warmup call, every call
    synchronized with its results' device."""
    _block(fn())
    t0 = time.perf_counter()
    for _ in range(n):
        _block(fn())
    return (time.perf_counter() - t0) * 1e3 / max(1, n)


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TuneResult:
    key: str                       # winners-table key (region keys x device)
    winner: Candidate
    from_cache: bool               # True: warm hit, nothing searched
    predicted_edp: Dict[str, float]    # candidate repr -> projected CiM EDP
    measured_ms: Dict[str, float]      # measured representatives only
    default_ms: Optional[float] = None
    tuned_ms: Optional[float] = None

    @property
    def tuned_vs_default_walltime_ratio(self) -> float:
        """>= 1.0 by construction: the default geometry is always in the
        measured set, and the winner is the measured minimum."""
        if not self.tuned_ms or not self.default_ms:
            return 1.0
        return self.default_ms / self.tuned_ms

    @property
    def tuned_vs_default_edp_ratio(self) -> float:
        """>= 1.0 by construction: losing predictions are pruned."""
        d = self.predicted_edp.get(repr(DEFAULT_CANDIDATE))
        w = self.predicted_edp.get(repr(self.winner))
        if not d or not w:
            return 1.0
        return d / w


class Autotuner:
    """Cost-model-pruned, measurement-confirmed geometry search with a
    bounded winners cache (see module docstring)."""

    def __init__(self, device: Optional[cost_mod.DeviceSpec] = None,
                 capacity: int = 64):
        self.device = device or cost_mod.DEFAULT_DEVICE
        self.winners: BoundedLRU = BoundedLRU(capacity)
        self.searches = 0

    # -- projection --------------------------------------------------------
    def predicted_edp(self, tr, cand: Candidate) -> float:
        """Projected total CiM EDP of `tr` on `cand`'s geometry/scheme,
        all eligible eqns counted (policy='always')."""
        plan = cost_mod.plan_offload(tr, spec=cand.spec(),
                                     scheme=cand.scheme, rows=cand.rows,
                                     device=self.device, policy="always")
        return sum(v.cim_edp for v in plan.verdicts)

    # -- cache key ---------------------------------------------------------
    def _key(self, tr, backend: Optional[str]) -> str:
        """Structural region keys of the DEFAULT-geometry lowering x the
        DeviceSpec — the dispatch schedule cache's keying discipline, so
        structurally identical workloads (repeated layers) share one
        winner."""
        # NOTE: the package __init__ rebinds the name `lower` to the
        # function, so pull the class straight from the submodule
        from .lower import LoweredComputation

        comp = LoweredComputation(
            tr, backend=backend, spec=DEFAULT_CANDIDATE.spec(),
            policy="always")
        region_keys = tuple(r.key for r in comp.regions)
        return repr((region_keys, self.device.key))

    # -- search ------------------------------------------------------------
    def tune(self, fn, args: Sequence, *,
             candidates: Optional[Sequence[Candidate]] = None,
             build: Optional[Callable[[Candidate], Tuple]] = None,
             backend: Optional[str] = None, measure: bool = True,
             steady_n: int = 5) -> TuneResult:
        """Search geometries for `fn(*args)`.

        `build(candidate) -> (fn, args)` lets candidates vary the traced
        function itself (the n_bits dimension: requantized weights); when
        omitted every candidate runs the same `fn`. Lowering for
        measurement uses `policy="always"` so geometries compare on
        identical work."""
        from .lower import lower as lower_fn
        from .trace import trace as trace_fn

        tr = trace_fn(fn, *args)
        key = self._key(tr, backend)
        cached = self.winners.get(key)
        if cached is not None:
            return TuneResult(key=key, winner=cached, from_cache=True,
                              predicted_edp={}, measured_ms={})

        self.searches += 1
        cands: List[Candidate] = [DEFAULT_CANDIDATE]
        for c in (candidates if candidates is not None
                  else DEFAULT_CANDIDATES):
            if c not in cands:
                cands.append(c)

        def traced(c: Candidate):
            if build is None:
                return tr, fn, args
            fn_c, args_c = build(c)
            return trace_fn(fn_c, *args_c), fn_c, args_c

        predicted: Dict[Candidate, float] = {}
        for c in cands:
            tr_c, _, _ = traced(c)
            predicted[c] = self.predicted_edp(tr_c, c)

        # prune: never measure a geometry projected worse than the default
        keep = [c for c in cands if predicted[c] <= predicted[cands[0]]]

        by_geom: Dict[Tuple, Candidate] = {}
        for c in keep:
            g = c.geom_key(with_bits=build is not None)
            if g not in by_geom or predicted[c] < predicted[by_geom[g]]:
                by_geom[g] = c

        measured: Dict[Candidate, float] = {}
        if measure:
            for c in by_geom.values():
                _, fn_c, args_c = traced(c)
                lowered = lower_fn(fn_c, backend=backend,
                                   spec=c.spec(), policy="always")
                measured[c] = steady_ms(lambda: lowered(*args_c),
                                        n=steady_n)
            winner = min(measured, key=lambda c: (measured[c],
                                                  predicted[c]))
            default_geom = cands[0].geom_key(with_bits=build is not None)
            default_ms = measured[by_geom[default_geom]]
            tuned_ms = measured[winner]
        else:
            winner = min(keep, key=lambda c: predicted[c])
            default_ms = tuned_ms = None

        self.winners.put(key, winner)
        return TuneResult(
            key=key, winner=winner, from_cache=False,
            predicted_edp={repr(c): predicted[c] for c in cands},
            measured_ms={repr(c): measured[c] for c in measured},
            default_ms=default_ms, tuned_ms=tuned_ms)

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        """Winners table -> JSON (CI artifact / serve warm-start)."""
        data = {
            "device": self.device.to_dict(),
            "searches": self.searches,
            "winners": [{"key": k, "winner": dataclasses.asdict(c)}
                        for k, c in self.winners.items()],
        }
        with open(path, "w") as f:
            json.dump(data, f, indent=2)

    def load(self, path: str) -> int:
        """Warm the winners table from `save`'s JSON; returns the number
        of entries loaded. A table saved under a DIFFERENT DeviceSpec is
        refused (its keys could never hit anyway)."""
        with open(path) as f:
            data = json.load(f)
        if data.get("device", {}).get("name") != self.device.name:
            raise ValueError(
                f"winners file {path} was tuned for device "
                f"{data.get('device', {}).get('name')!r}, not "
                f"{self.device.name!r}")
        n = 0
        for entry in data.get("winners", []):
            self.winners.put(entry["key"], Candidate(**entry["winner"]))
            n += 1
        return n
