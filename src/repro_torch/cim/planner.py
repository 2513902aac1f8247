"""Macro-op planner: lower multi-access CiM arithmetic to access schedules.

Port of `repro.cim.planner`. A `Schedule`
is an ordered tuple of `Step`s, each exactly one engine access, and
`Schedule.accesses == len(steps)` is the number of ADRA array accesses the
macro performs: `repro_torch.cim.macro` executes schedules through a cursor
that refuses to deviate from them, so the ledger's access count provably
equals the planned count. `placed()` pins a schedule to a banked
geometry, and `placed_accesses` is then the activation count the ledger
shows. `concat_schedules` fuses a run of schedules into one region plan,
and `schedule_traffic_bytes` models a schedule's device-memory bytes fused
against unfused. The module holds no tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from . import opset
from .array import ArraySpec, TilePlan


@dataclasses.dataclass(frozen=True)
class Step:
    """One planned ADRA access.

    ops    : the fused op-set of this access (one engine.execute call).
    role   : dataflow role — 'pp' (partial product), 'acc' (accumulate),
             'neg' (negate-from-zero), 'reduce' (tree-reduction add),
             'pred' (predicate for a peripheral select), 'pair' (popcount
             pairwise add).
    shift  : plane (weight) shift applied to this step's operand, in planes.
    stride : element stride of the row-buffer shift feeding this step.
    """

    ops: Tuple[str, ...]
    role: str
    shift: int = 0
    stride: int = 0


@dataclasses.dataclass(frozen=True)
class Schedule:
    """An ordered access plan for one macro op (or a fused region of ops).

    `placement` (set by `placed()`) pins the schedule to a banked array
    geometry: every step then executes as `placement.n_tiles` bank
    activations through the tiling dispatcher, and `placed_accesses` is the
    physical activation count the ledger will show.

    `segments` (set by `concat_schedules`) records the per-op boundaries of
    a fused region plan: an ordered tuple of (macro name, step count) pairs
    summing to len(steps) — the lowering compiler's provenance trail.

    `operands`/`resident` name the macro's operand sides and the subset
    already pinned in array rows: a resident side skips the entry pack (and
    its ledger load charges) when the schedule executes, and because
    Schedule is part of every compiled-program cache key, two executions of
    the same macro with different residency compile to different programs.
    """

    macro: str
    steps: Tuple[Step, ...]
    out_bits: int                 # width of the macro's result planes
    placement: Optional[TilePlan] = None
    segments: Optional[Tuple[Tuple[str, int], ...]] = None
    operands: Tuple[str, ...] = ()
    resident: Tuple[str, ...] = ()

    @property
    def accesses(self) -> int:
        return len(self.steps)

    @property
    def placed_accesses(self) -> int:
        """Bank activations when placed (accesses * tiles); logical accesses
        when not."""
        tiles = self.placement.n_tiles if self.placement else 1
        return len(self.steps) * tiles

    @property
    def placed_waves(self) -> int:
        """Serialized wave count when placed (accesses * waves per step —
        the critical path the cost model's latency term charges); logical
        accesses when not."""
        waves = self.placement.waves if self.placement else 1
        return len(self.steps) * waves

    def placed(self, spec: ArraySpec, n_words: int) -> "Schedule":
        """The same schedule carrying its tile placement on `spec`."""
        return dataclasses.replace(self, placement=spec.plan(n_words))

    def with_operands(self, *names: str) -> "Schedule":
        """The same schedule naming its operand sides (e.g. 'lhs', 'rhs')."""
        return dataclasses.replace(self, operands=tuple(names))

    def with_resident(self, *names: str) -> "Schedule":
        """The same schedule marking `names` as resident operand sides."""
        unknown = tuple(n for n in names if n not in self.operands)
        if unknown:
            raise opset.CimOpError(
                f"resident sides {unknown} not among operands "
                f"{self.operands} of macro {self.macro!r}")
        return dataclasses.replace(self, resident=tuple(names))

    def op_passes(self) -> Tuple[Tuple[str, ...], ...]:
        return tuple(s.ops for s in self.steps)

    def __add__(self, other: "Schedule") -> "Schedule":
        return Schedule(macro=f"{self.macro}+{other.macro}",
                        steps=self.steps + other.steps,
                        out_bits=max(self.out_bits, other.out_bits),
                        placement=self.placement or other.placement)


def _log2_ceil(n: int) -> int:
    r = 0
    while (1 << r) < n:
        r += 1
    return r


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


def plan_multiply(n_bits_a: int, n_bits_b: int,
                  signed_b: bool = True) -> Schedule:
    """Shift-and-add multiply: one AND access per multiplier bit (partial
    product against the sign-extended multiplicand), one add access per
    accumulation; the top bit of a signed multiplier carries weight
    -2^(n-1), so its partial product is *subtracted* — the engine's
    single-access sub makes that free of extra passes."""
    if n_bits_a < 1 or n_bits_b < 1:
        raise opset.CimOpError(
            f"multiply needs positive widths, got {n_bits_a}x{n_bits_b}")
    steps = []
    for i in range(n_bits_b):
        last_signed = signed_b and i == n_bits_b - 1
        steps.append(Step(("and",), role="pp", shift=i))
        if i == 0:
            if last_signed:            # 1-bit signed multiplier: b in {0,-1}
                steps.append(Step(("sub",), role="neg", shift=i))
        else:
            steps.append(Step(("sub" if last_signed else "add",),
                              role="acc", shift=i))
    return Schedule("multiply", tuple(steps), out_bits=n_bits_a + n_bits_b)


def plan_elementwise(ops: Tuple[str, ...], out_bits: int,
                     macro: Optional[str] = None) -> Schedule:
    """One single-access elementwise step: every op in `ops` from the same
    dual-row activation (add/sub/compare/any Boolean function)."""
    ops = opset.validate_ops(tuple(ops))
    return Schedule(macro or "+".join(ops), (Step(ops, role="ew"),),
                    out_bits=out_bits)


def plan_neg(n_bits: int) -> Schedule:
    """0 - a: one sub access against the array's zero row."""
    return Schedule("neg", (Step(("sub",), role="neg"),), out_bits=n_bits + 1)


def plan_abs(n_bits: int) -> Schedule:
    """abs via the sub chain: ONE access computes 0 - a and the 0 < a
    predicate together; a peripheral select between a and -a finishes it."""
    return Schedule("abs", (Step(("sub", "lt"), role="pred"),),
                    out_bits=n_bits + 1)


def plan_relu(n_bits: int) -> Schedule:
    """relu: one access for the a > 0 predicate; peripheral select a vs 0."""
    return Schedule("relu", (Step(("gt",), role="pred"),), out_bits=n_bits)


def plan_minimum(n_bits: int) -> Schedule:
    return Schedule("minimum", (Step(("lt",), role="pred"),), out_bits=n_bits)


def plan_maximum(n_bits: int) -> Schedule:
    return Schedule("maximum", (Step(("gt",), role="pred"),), out_bits=n_bits)


def plan_popcount(n_bits: int) -> Schedule:
    """Pairwise tree over the n single-bit planes: n - 1 add accesses."""
    if n_bits < 1:
        raise opset.CimOpError(f"popcount needs positive width, got {n_bits}")
    steps, level = [], n_bits
    while level > 1:
        pairs = level // 2
        steps.extend(Step(("add",), role="pair") for _ in range(pairs))
        level = pairs + (level % 2)
    return Schedule("popcount", tuple(steps),
                    out_bits=_log2_ceil(n_bits + 1) + 1)


def plan_reduce_sum(n_elems: int, stride: int = 1,
                    n_bits: int = 32) -> Schedule:
    """Log-stride tree reduction: ceil(log2(n)) add accesses, each fed by a
    zero-fill row-buffer shift of stride * 2^r elements. Element 0 (of each
    stride-aligned segment) holds the sum afterwards."""
    if n_elems < 1:
        raise opset.CimOpError(f"reduce needs at least one element, {n_elems}")
    steps = tuple(Step(("add",), role="reduce", stride=stride << r)
                  for r in range(_log2_ceil(n_elems)))
    return Schedule("reduce_sum", steps,
                    out_bits=n_bits + _log2_ceil(n_elems))


def plan_matmul(k: int, n_cols: int, n_bits: int = 8,
                signed: bool = True, resident_rhs: bool = False) -> Schedule:
    """int x int -> wide-int matmul over a [M, K_pad, N] broadcast layout:
    ONE shift-and-add multiply over the whole expanded tensor (word
    parallelism makes the access count independent of M and N) followed by a
    log2(K_pad) stride-N tree reduction over the contraction axis.

    `resident_rhs` marks the rhs (weight) side as pinned in array rows: the
    step sequence is identical — residency changes operand loading, never
    the access count — but the schedule names the rhs resident so executors
    skip its entry pack and compiled programs key on residency."""
    if k < 1 or n_cols < 1:
        raise opset.CimOpError(f"matmul needs k, n >= 1, got {k}, {n_cols}")
    k_pad = 1 << _log2_ceil(k)
    mul = plan_multiply(n_bits, n_bits, signed_b=signed)
    red = plan_reduce_sum(k_pad, stride=n_cols, n_bits=mul.out_bits)
    sched = Schedule("matmul", mul.steps + red.steps, out_bits=red.out_bits,
                     operands=("lhs", "rhs"))
    return sched.with_resident("rhs") if resident_rhs else sched


def plan_dot(k: int, n_bits: int = 8, signed: bool = True) -> Schedule:
    sched = plan_matmul(k, 1, n_bits=n_bits, signed=signed)
    return dataclasses.replace(sched, macro="dot")


def plan_batched_matmul(batch: int, k: int, n_cols: int, n_bits: int = 8,
                        signed: bool = True,
                        resident_rhs: bool = False) -> Schedule:
    """Batched intN contraction [*B, M, K] x [*B, K, N] over the SAME
    broadcast word layout as `plan_matmul`, with the batch dims flattened
    onto the word/tile axis: the expanded operand stack is
    [B_flat * M, K_pad, N] and the step sequence — one shift-and-add
    multiply plus a log2(K_pad) stride-N tree reduction — is IDENTICAL to
    the 2-D plan. Batch size scales the word count (and therefore the tile
    placement) but NEVER the access count per tile: that independence is
    the whole eligibility argument for putting attention's per-head
    contractions in the banks.

    The stride-N reduction is correct in the flattened layout for the same
    reason it is correct across the 2-D plan's M axis: each (b, m) block
    owns a contiguous K_pad * N word segment, partial sums that a high-k
    shift drags across a block boundary land on k > 0 slots, and the exit
    gather reads only the k = 0 slice of every block.

    `resident_rhs` names the rhs (the attention K^T / V side) resident,
    exactly as in `plan_matmul`: same steps, different operand loading,
    different compiled-program identity."""
    if batch < 1:
        raise opset.CimOpError(f"batched matmul needs batch >= 1, got {batch}")
    if k < 1 or n_cols < 1:
        raise opset.CimOpError(f"matmul needs k, n >= 1, got {k}, {n_cols}")
    k_pad = 1 << _log2_ceil(k)
    mul = plan_multiply(n_bits, n_bits, signed_b=signed)
    red = plan_reduce_sum(k_pad, stride=n_cols, n_bits=mul.out_bits)
    sched = Schedule("batched_matmul", mul.steps + red.steps,
                     out_bits=red.out_bits, operands=("lhs", "rhs"))
    return sched.with_resident("rhs") if resident_rhs else sched


def concat_schedules(schedules: Sequence[Schedule],
                     macro: str = "region") -> Schedule:
    """Fuse an ordered run of schedules into ONE region plan: the step-wise
    concatenation, run through one ScheduleCursor, with `segments` keeping
    the per-op boundaries."""
    schedules = list(schedules)
    if not schedules:
        raise opset.CimOpError("cannot concatenate zero schedules")
    steps: Tuple[Step, ...] = ()
    segments = []
    for s in schedules:
        steps = steps + s.steps
        segments.append((s.macro, len(s.steps)))
    return Schedule(macro=macro, steps=steps,
                    out_bits=max(s.out_bits for s in schedules),
                    segments=tuple(segments))


PLANS = {
    "multiply": plan_multiply,
    "neg": plan_neg,
    "abs": plan_abs,
    "relu": plan_relu,
    "minimum": plan_minimum,
    "maximum": plan_maximum,
    "popcount": plan_popcount,
    "reduce_sum": plan_reduce_sum,
    "matmul": plan_matmul,
    "dot": plan_dot,
    "batched_matmul": plan_batched_matmul,
}


def schedule_traffic_bytes(schedule: Schedule, n_bits: int, n_words32: int,
                           working_bits: Optional[int] = None
                           ) -> Dict[str, float]:
    """Device-memory byte model of a schedule fused vs unfused.

    Fused: both operand stacks stream ONCE and the result is written once;
    every intermediate stays in the array, and a resident side streams
    nothing. Unfused (the near-memory baseline): each step re-reads its two
    operand stacks at the working width and writes its outputs back."""
    w = working_bits if working_bits is not None else schedule.out_bits
    plane_bytes = 4 * n_words32
    streamed_sides = 2 - min(len(schedule.resident), 2)
    fused = (streamed_sides * n_bits + schedule.out_bits) * plane_bytes
    baseline = 0.0
    for step in schedule.steps:
        out_rows = sum(opset.out_rows(op, w) for op in step.ops)
        baseline += (2 * w + out_rows) * plane_bytes
    return {"fused": float(fused), "baseline": float(baseline),
            "ratio": baseline / fused}
