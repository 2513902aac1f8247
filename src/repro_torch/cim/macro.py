"""Macro-op executors: multi-access CiM arithmetic over the single-access
engine, one cached schedule program per schedule.

Port of `repro.cim.macro`. Every macro executes a `planner.Schedule`
through a cursor that allows exactly the planned accesses (same order, same
op-sets) and nothing else, so ledger accesses == schedule.accesses by
construction — or, on a banked `spec`, == schedule.placed_accesses: the
cursor then routes every access through the tiling dispatcher.

`run_schedule_program` is the counterpart of the reference's one jitted
XLA program per schedule (DESIGN.md §8): the first call under a key runs
the body eagerly through a recording cursor and stores it with its
charge-from-plan record (`PlannedCharges`) in the dispatch layer's bounded
LRU as a `CompiledSchedule`; on CUDA the second call captures the whole
body — every access, the packed-domain peripherals between them, the
entry packs and the exit unpack — as ONE CUDA graph, and every later call
replays it: one device launch (`dispatch.Program`). Every call, first or
warm, is ONE dispatch whose recorded charges replay into the ledger, and
the fused kernel's launch count moves as the eager body's would. CPU and
`meta` tensors run the body eagerly every call. Over a mesh the body's
tiled accesses run inline in the capture, so their all-gathers join the
schedule's one graph (`dispatch.captures`: the mesh's groups are NCCL).
XLA also fuses the peripherals; a graph replays them as the body
launched them.

Operands, partial products, accumulators and tree levels all stay in the
PlanePack packed domain; the only codec entries are the entry packs and the
exit unpack.

Macros:

  multiply   — shift-and-add; signed multipliers subtract the MSB partial
               product (single-access sub, the paper's headline op)
  abs_/relu  — sub-chain predicate + zero-cost peripheral select
  minimum/maximum — lt/gt predicate + select, one access each
  popcount   — pairwise plane tree, n-1 add accesses
  reduce_sum — log-stride tree reduction with row-buffer shifts
  dot/matmul/batched_matmul — int x int -> wide-int contraction: one
               multiply over a broadcast [M, K_pad, N] layout + a stride-N
               reduction; the access count depends only on the bit width
               and K, never on M or N

`ChainExecutor` runs a fused region plan (`planner.concat_schedules`)
through one shared cursor.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.spans import span
from . import dispatch, engine, planner
from .accounting import LEDGER, PlannedCharges
from .array import ArraySpec
from .backends import get_backend
from .opset import CimOpError
from .planepack import PlanePack


class ScheduleCursor:
    """Executes a Schedule one access at a time, refusing to deviate.

    With a `spec` every access runs through the banked tiling dispatcher
    and costs `plan.n_tiles` activations; a `mesh` spreads the tiles over
    its "data" axis (`dispatch.execute_tiled`). With `charges` (a list) the
    cursor is in traced mode: accesses run through the side-effect-free
    `execute_traced` forms and every planned charge is appended to
    `charges`, the record `run_schedule_program` replays per call; without
    it each access charges the ledger directly."""

    def __init__(self, schedule: planner.Schedule,
                 backend: Optional[str] = None,
                 spec: Optional[ArraySpec] = None, mesh=None,
                 charges: Optional[list] = None):
        self.schedule = schedule
        self.backend = backend
        self.spec = spec
        self.mesh = mesh
        self.charges = charges
        self._i = 0

    def step(self) -> planner.Step:
        if self._i >= len(self.schedule.steps):
            raise CimOpError(
                f"{self.schedule.macro}: executor exceeded its planned "
                f"{self.schedule.accesses} accesses")
        return self.schedule.steps[self._i]

    def execute(self, a: PlanePack, b: PlanePack,
                ops: Sequence[str]) -> engine.Outputs:
        step = self.step()
        if tuple(ops) != step.ops:
            raise CimOpError(
                f"{self.schedule.macro}: access {self._i} executes {ops!r} "
                f"but the plan says {step.ops!r}")
        self._i += 1
        if self.charges is not None:
            if self.spec is None:
                return engine.execute_traced(a, b, step.ops,
                                             backend=self.backend,
                                             charges=self.charges)
            return dispatch.execute_tiled_traced(
                a, b, step.ops, spec=self.spec, backend=self.backend,
                mesh=self.mesh,
                charges=self.charges)
        if self.spec is None:
            return engine.execute(a, b, step.ops, backend=self.backend)
        return dispatch.execute_tiled(a, b, step.ops, spec=self.spec,
                                      backend=self.backend, mesh=self.mesh)

    def charge_reduction(self, words32: float) -> None:
        """Inter-bank reduction traffic of one strided step."""
        if self.charges is not None:
            self.charges.append(("reduction", float(words32)))
        else:
            LEDGER.charge_reduction(words32)

    def charge_load(self, n_bits: int, n_words: int) -> None:
        """Operand-load row-writes of one STREAMED entry pack: one load
        access per tile it lands on (one tile unbanked)."""
        n_tiles = self.spec.plan(n_words).n_tiles if self.spec else 1
        if self.charges is not None:
            self.charges.append(("load", n_bits, n_words, n_tiles))
        else:
            LEDGER.charge_load(n_bits, n_words, n_tiles=n_tiles)

    def charge_resident(self, n_bits: int, n_words: int) -> None:
        """One resident-operand reuse: entry pack (and its loads) skipped."""
        if self.charges is not None:
            self.charges.append(("resident", n_bits, n_words))
        else:
            LEDGER.charge_resident_reuse(n_bits, n_words)

    def remaining(self) -> Tuple[planner.Step, ...]:
        return self.schedule.steps[self._i:]

    def finish(self) -> None:
        if self._i != len(self.schedule.steps):
            raise CimOpError(
                f"{self.schedule.macro}: executed {self._i} of "
                f"{self.schedule.accesses} planned accesses")


# ---------------------------------------------------------------------------
# whole-schedule programs: one dispatch per macro
# ---------------------------------------------------------------------------


class CompiledSchedule(dispatch.Program):
    """A cached schedule program plus its charge-from-plan record. Calling
    it runs the program (the eager body, or on CUDA its graph) and then
    replays the recorded charges: ONE dispatch."""

    __slots__ = ("charges",)

    def __init__(self, fn, charges: PlannedCharges, first=None, mesh=None):
        super().__init__(fn, first=first, mesh=mesh)
        self.charges = charges

    def __call__(self, *leaves):
        # invoke first, account after: a failed invocation must not leave
        # the ledger charged (or the dispatch counter bumped)
        out = super().__call__(*leaves)
        self.charges.replay()
        dispatch.count_dispatch()
        return out


def aval_sig(aval) -> Tuple:
    """Cache-key signature of one abstract value (anything with `.shape`
    and `.dtype`: a tensor, a `trace.Aval`): what a program's body depends
    on. The ONE definition of that discipline; the lowering compiler's
    region keys use it too."""
    return (tuple(int(d) for d in aval.shape), str(aval.dtype))


def _leaf_sig(x) -> Tuple:
    """Cache-key signature of one operand (a tensor or a PlanePack): what
    a program depends on."""
    if isinstance(x, PlanePack):
        return ("pack", x.n_bits, x.signed, x.shape) + _leaf_sig(x.planes)
    return aval_sig(x) + (x.device.type,)


def run_schedule_program(schedule: planner.Schedule, body, operands,
                         body_key=(), backend: Optional[str] = None,
                         spec: Optional[ArraySpec] = None, mesh=None):
    """Execute `body(cursor, *operands)` as ONE schedule program.

    Cached in the dispatch layer's bounded LRU under the schedule, the body
    identity (`body_key`), the operand signatures, the backend, the banked
    geometry and the mesh (by identity, `dispatch.mesh_key`): a repeat
    hits (no new program), runs the cached program (on CUDA: captures it
    at the first hit, replays it after) and
    replays the charges recorded the first time — accesses ==
    schedule.accesses (placed_accesses on a `spec`) either way. The body's
    accesses take the traced forms, which never see the fault overlay:
    the reference's programs are jitted, so a streamed fault campaign
    injects nothing into them (and draws nothing for them). A body must be
    capturable: the tensors it makes from host values are made at its
    first call and kept (`lower`'s region literals)."""
    with span("repro.cim.program"):
        bk_name = get_backend(backend).name
        leaves = tuple(operands)
        key = ("step-program", schedule, tuple(body_key),
               tuple(_leaf_sig(x) for x in leaves), bk_name, spec,
               dispatch.mesh_key(mesh))
        prog = dispatch.program_cache_get(key)
        if prog is not None:
            return prog(*leaves)

        def run(charges: list, *args):
            cur = ScheduleCursor(schedule, bk_name, spec=spec, mesh=mesh,
                                 charges=charges)
            out = body(cur, *args)
            cur.finish()
            return out

        charges: list = []
        out = run(charges, *leaves)
        planned = PlannedCharges(tuple(charges))
        if planned.accesses != schedule.accesses:   # pragma: no cover
            raise CimOpError(
                f"{schedule.macro}: recorded {planned.accesses} accesses "
                f"but the plan has {schedule.accesses}")
        dispatch.program_cache_put(
            key, CompiledSchedule(lambda *args: run([], *args), planned,
                                  first=leaves, mesh=mesh))
        planned.replay()
        dispatch.count_dispatch()
        return out


def _place(sched: planner.Schedule, spec: Optional[ArraySpec],
           n_words: int) -> planner.Schedule:
    """Pin a schedule to the banked geometry, when one is given."""
    return sched.placed(spec, n_words) if spec is not None else sched


# ---------------------------------------------------------------------------
# peripheral select (zero accesses)
# ---------------------------------------------------------------------------


def select(pred: PlanePack, x: PlanePack, y: PlanePack) -> PlanePack:
    """Per-word mux pred ? x : y, as predicated writeback in the periphery:
    the 1-plane predicate gates which operand's planes reach the row
    buffer — no array access."""
    if pred.planes.shape[0] != 1:
        raise CimOpError("select predicate must be a 1-plane bitmap")
    if x.signed != y.signed:
        n = max(x.n_bits, y.n_bits) + 1   # room so both read as signed
        x, y = x.extend_to(n).as_signed(True), y.extend_to(n).as_signed(True)
    x, y = x.align(y)
    mask = pred.planes[0]
    planes = (x.planes & mask) | (y.planes & ~mask)
    return PlanePack(planes=planes, n_bits=x.n_bits, signed=x.signed,
                     shape=x.shape)


def _plane_mask(bitmap: torch.Tensor, n_bits: int,
                like: PlanePack) -> PlanePack:
    """One multiplier-bit bitmap replicated across n_bits planes (the same
    enable asserted on every plane row — free wiring)."""
    return PlanePack(planes=bitmap.unsqueeze(0).expand(n_bits, -1),
                     n_bits=n_bits, signed=True, shape=like.shape)


# ---------------------------------------------------------------------------
# multiply
# ---------------------------------------------------------------------------


def _multiply_with(cur: ScheduleCursor, a: PlanePack,
                   b: PlanePack) -> PlanePack:
    """Shift-and-add over a cursor: one AND access per multiplier bit, one
    add (sub for a signed multiplier's MSB) per accumulation."""
    w = a.n_bits + b.n_bits
    a_ext = a.extend_to(w).as_signed(True)
    acc: Optional[PlanePack] = None
    for i in range(b.n_bits):
        last_signed = b.signed and i == b.n_bits - 1
        pp = cur.execute(a_ext, _plane_mask(b.planes[i], w, a), ("and",))
        # AND of a sign-extended word against a replicated enable bit is a
        # valid two's-complement word; shift = weight 2^i, truncation keeps
        # the arithmetic modulo 2^w
        shifted = pp["and"].as_signed(True).truncate_to(w - i).shift_up(i)
        if acc is None:
            if last_signed:            # 1-bit signed multiplier: b in {0,-1}
                zero = PlanePack.zeros_like(shifted)
                acc = cur.execute(zero, shifted, ("sub",))["sub"]
            else:
                acc = shifted
        else:
            op = "sub" if last_signed else "add"
            acc = cur.execute(acc, shifted, (op,))[op]
        acc = acc.truncate_to(w)
    return acc.as_signed(a.signed or b.signed)


def multiply(a: PlanePack, b: PlanePack, backend: Optional[str] = None,
             spec: Optional[ArraySpec] = None, mesh=None) -> PlanePack:
    """Exact product, (n_a + n_b)-plane result, 2*n_b - 1 accesses (times
    the tile count on a banked `spec`) — one dispatch."""
    if a.shape != b.shape:
        raise CimOpError(f"operand shapes differ: {a.shape} vs {b.shape}")
    sched = _place(planner.plan_multiply(a.n_bits, b.n_bits,
                                         signed_b=b.signed), spec, a.n_words)
    return run_schedule_program(sched, _multiply_with, (a, b),
                                body_key=("multiply",), backend=backend,
                                spec=spec, mesh=mesh)


# ---------------------------------------------------------------------------
# select-based macros: abs / relu / min / max
# ---------------------------------------------------------------------------


def _abs_with(cur: ScheduleCursor, a: PlanePack) -> PlanePack:
    out = cur.execute(PlanePack.zeros_like(a), a, ("sub", "lt"))
    return select(out["lt"], a, out["sub"])


def _relu_with(cur: ScheduleCursor, a: PlanePack) -> PlanePack:
    zero = PlanePack.zeros_like(a)
    return select(cur.execute(a, zero, ("gt",))["gt"], a, zero)


def _minimum_with(cur: ScheduleCursor, a: PlanePack,
                  b: PlanePack) -> PlanePack:
    return select(cur.execute(a, b, ("lt",))["lt"], a, b)


def _maximum_with(cur: ScheduleCursor, a: PlanePack,
                  b: PlanePack) -> PlanePack:
    return select(cur.execute(a, b, ("gt",))["gt"], a, b)


def abs_(a: PlanePack, backend: Optional[str] = None,
         spec: Optional[ArraySpec] = None, mesh=None) -> PlanePack:
    """|a| in one access: (0 - a, 0 < a) together, then select a vs -a. The
    result has n+1 planes, so abs(INT_MIN) is exact."""
    sched = _place(planner.plan_abs(a.n_bits), spec, a.n_words)
    return run_schedule_program(sched, _abs_with, (a,), body_key=("abs",),
                                backend=backend, spec=spec, mesh=mesh)


def relu(a: PlanePack, backend: Optional[str] = None,
         spec: Optional[ArraySpec] = None, mesh=None) -> PlanePack:
    """max(a, 0) in one access: the a > 0 predicate gates the writeback."""
    sched = _place(planner.plan_relu(a.n_bits), spec, a.n_words)
    return run_schedule_program(sched, _relu_with, (a,), body_key=("relu",),
                                backend=backend, spec=spec, mesh=mesh)


def minimum(a: PlanePack, b: PlanePack, backend: Optional[str] = None,
            spec: Optional[ArraySpec] = None, mesh=None) -> PlanePack:
    sched = _place(planner.plan_minimum(max(a.n_bits, b.n_bits)), spec,
                   a.n_words)
    return run_schedule_program(sched, _minimum_with, (a, b),
                                body_key=("minimum",), backend=backend,
                                spec=spec, mesh=mesh)


def maximum(a: PlanePack, b: PlanePack, backend: Optional[str] = None,
            spec: Optional[ArraySpec] = None, mesh=None) -> PlanePack:
    sched = _place(planner.plan_maximum(max(a.n_bits, b.n_bits)), spec,
                   a.n_words)
    return run_schedule_program(sched, _maximum_with, (a, b),
                                body_key=("maximum",), backend=backend,
                                spec=spec, mesh=mesh)


# ---------------------------------------------------------------------------
# popcount / reductions
# ---------------------------------------------------------------------------


def _popcount_with(cur: ScheduleCursor, a: PlanePack) -> PlanePack:
    level = [PlanePack(planes=a.planes[i:i + 1], n_bits=1, signed=False,
                       shape=a.shape)
             for i in range(a.n_bits)]
    while len(level) > 1:
        nxt = [cur.execute(level[j], level[j + 1], ("add",))["add"]
               for j in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def popcount(a: PlanePack, backend: Optional[str] = None,
             spec: Optional[ArraySpec] = None, mesh=None) -> PlanePack:
    """Set bits of each word's n-bit two's-complement pattern: pairwise
    plane tree, n - 1 add accesses."""
    sched = _place(planner.plan_popcount(a.n_bits), spec, a.n_words)
    return run_schedule_program(sched, _popcount_with, (a,),
                                body_key=("popcount",), backend=backend,
                                spec=spec, mesh=mesh)


def _reduce_with(cur: ScheduleCursor, acc: PlanePack,
                 n_steps: Optional[int] = None) -> PlanePack:
    """Log-stride reduction: each planned step shifts the row buffer by its
    stride and adds, so element 0 of each segment accumulates the segment
    sum; exactness relies on the pack's zero padding past the last word.

    `n_steps` bounds the walk (a region cursor may continue past it). On a
    banked cursor a stride that reaches across a tile boundary moves words
    between banks: the ledger's inter-bank traffic, stride / tile_words of
    the words, capped at all of them."""
    if not acc.signed:
        acc = acc.extend_to(acc.n_bits + 1).as_signed(True)
    steps = cur.remaining()
    if n_steps is not None:
        steps = steps[:n_steps]
    for step in steps:
        if cur.spec is not None and step.stride:
            plan = cur.spec.plan(acc.n_words)
            if plan.n_tiles > 1:
                frac = min(1.0, step.stride / plan.tile_words)
                cur.charge_reduction(acc.n_words * frac * acc.n_bits / 32.0)
        shifted = acc.shift_elements(step.stride)
        acc = cur.execute(acc, shifted, ("add",))["add"]
    return acc


def _reduce_sum_body(cur: ScheduleCursor, a: PlanePack) -> PlanePack:
    acc = _reduce_with(cur, a)
    return PlanePack(planes=acc.planes, n_bits=acc.n_bits,
                     signed=acc.signed, shape=())


def reduce_sum(a: PlanePack, backend: Optional[str] = None,
               spec: Optional[ArraySpec] = None, mesh=None) -> PlanePack:
    """Sum of ALL logical elements, ceil(log2(n_words)) accesses; returns a
    scalar-shaped pack (element 0 of the tree)."""
    sched = _place(planner.plan_reduce_sum(a.n_words, stride=1,
                                           n_bits=a.n_bits), spec, a.n_words)
    return run_schedule_program(sched, _reduce_sum_body, (a,),
                                body_key=("reduce_sum",), backend=backend,
                                spec=spec, mesh=mesh)


# ---------------------------------------------------------------------------
# quantized matmul / batched matmul
# ---------------------------------------------------------------------------


def _expand_rhs(b3: torch.Tensor, m: int, k_pad: int) -> torch.Tensor:
    """[B, K, N] -> the [B*M, K_pad, N] broadcast layout (zero K padding)."""
    bf, k, n = b3.shape
    b_exp = torch.zeros((bf, m, k_pad, n), dtype=torch.int32, device=b3.device)
    b_exp[:, :, :k, :] = b3.to(torch.int32).unsqueeze(1)
    return b_exp.reshape(bf * m, k_pad, n)


def _expand_lhs(a2: torch.Tensor, k_pad: int, n: int) -> torch.Tensor:
    """[R, K] -> the [R, K_pad, N] broadcast layout (zero K padding)."""
    r, k = a2.shape
    a_exp = torch.zeros((r, k_pad, n), dtype=torch.int32, device=a2.device)
    a_exp[:, :k, :] = a2.to(torch.int32).unsqueeze(-1)
    return a_exp


def matmul_rhs_pack(b: torch.Tensor, m: int, n_bits: int,
                    signed: bool = True) -> PlanePack:
    """The expanded [M, K_pad, N] rhs entry pack of a matmul — the plane
    stack a ResidentSet pins so warm calls skip building (and loading) it."""
    if b.dim() != 2:
        raise CimOpError(f"matmul rhs must be [K, N], got {tuple(b.shape)}")
    k_pad = 1 << planner._log2_ceil(int(b.shape[0]))
    return PlanePack.pack(_expand_rhs(b.unsqueeze(0), m, k_pad), n_bits,
                          signed=signed)


def batched_matmul_rhs_pack(b: torch.Tensor, m: int, n_bits: int,
                            signed: bool = True) -> PlanePack:
    """The expanded [B_flat * M, K_pad, N] rhs entry pack of a batched
    matmul ([*B, K, N] rhs broadcast over the lhs's M rows)."""
    if b.dim() < 3:
        raise CimOpError(f"batched matmul rhs must be [*B, K, N], "
                         f"got {tuple(b.shape)}")
    k, n = int(b.shape[-2]), int(b.shape[-1])
    k_pad = 1 << planner._log2_ceil(k)
    return PlanePack.pack(_expand_rhs(b.reshape(-1, k, n), m, k_pad), n_bits,
                          signed=signed)


def _contract_with(cur: ScheduleCursor, a2: torch.Tensor, b3, m: int,
                   bf: int, n_bits: int, signed: bool,
                   b_pack: Optional[PlanePack],
                   out_shape: Tuple[int, ...]) -> PlanePack:
    """The shared matmul dataflow over an open cursor: broadcast
    [B_flat * M, K_pad, N] operand layout, ONE shift-and-add multiply, a
    log2(K_pad) stride-N tree reduction, and the k = 0 slice of every
    (b, m) block gathered to the result pack. Cross-block partial sums land
    on discarded k > 0 slots. With `b_pack` the rhs is RESIDENT: its
    expansion and entry pack are skipped and it charges one zero-load
    reuse; the streamed lhs pays its load."""
    k = int(a2.shape[-1])
    if b_pack is not None:
        mm, k_pad, n = b_pack.shape
        if mm != bf * m or k > k_pad:
            raise CimOpError(
                f"resident rhs pack {b_pack.shape} does not match lhs "
                f"[{bf}x{m}, {k}] (expanded for {mm} rows, K_pad={k_pad})")
        pb = b_pack
    else:
        n = int(b3.shape[-1])
        k_pad = 1 << planner._log2_ceil(k)
        pb = PlanePack.pack(_expand_rhs(b3, m, k_pad), n_bits, signed=signed)
        cur.charge_load(n_bits, pb.n_words)
    pa = PlanePack.pack(_expand_lhs(a2, k_pad, n), n_bits, signed=signed)
    cur.charge_load(n_bits, pa.n_words)
    if b_pack is not None:
        cur.charge_resident(n_bits, pb.n_words)

    prod = _multiply_with(cur, pa, pb)
    del pa
    acc = _reduce_with(cur, prod, n_steps=planner._log2_ceil(k_pad))
    dev = acc.planes.device
    idx = (torch.arange(bf * m, device=dev)[:, None] * (k_pad * n)
           + torch.arange(n, device=dev)[None, :])
    return acc.take_words(idx.reshape(-1), out_shape)


def matmul(a: torch.Tensor, b: Optional[torch.Tensor] = None,
           n_bits: int = 8, backend: Optional[str] = None,
           spec: Optional[ArraySpec] = None,
           b_pack: Optional[PlanePack] = None, mesh=None) -> torch.Tensor:
    """Exact intN x intN -> int32 matmul through the CiM array.

    a : int [M, K], b : int [K, N], entries representable in n_bits signed.
    ONE shift-and-add multiply over the broadcast [M, K_pad, N] layout plus
    a log2(K_pad) stride-N tree reduction: (2*n_bits - 1) + ceil(log2 K)
    accesses regardless of M and N, times the tile count on a banked
    `spec`.

    With `b_pack` (a pinned `matmul_rhs_pack`; `b` may then be None) the
    rhs is RESIDENT: the schedule names it so, the program keys on that
    residency, and only the lhs pays operand loads."""
    if a.dim() != 2:
        raise CimOpError(f"matmul needs [M,K] lhs, got {tuple(a.shape)}")
    m, k = (int(d) for d in a.shape)
    if b_pack is not None:
        m2, k_pad, n = b_pack.shape
        sched = _place(planner.plan_matmul(k_pad, n, n_bits=n_bits,
                                           signed=True, resident_rhs=True),
                       spec, m2 * k_pad * n)

        def body_res(cur, a_, bp):
            return _contract_with(cur, a_, None, m, 1, n_bits, True, bp,
                                  (m, n)).unpack()

        return run_schedule_program(
            sched, body_res, (a, b_pack),
            body_key=("matmul", n_bits, "resident"),
            backend=backend, spec=spec, mesh=mesh)
    if b is None or b.dim() != 2 or int(b.shape[0]) != k:
        raise CimOpError(f"matmul needs [M,K] x [K,N], got {tuple(a.shape)} "
                         f"{None if b is None else tuple(b.shape)}")
    n = int(b.shape[1])
    k_pad = 1 << planner._log2_ceil(k)
    sched = _place(planner.plan_matmul(k, n, n_bits=n_bits, signed=True),
                   spec, m * k_pad * n)

    def body(cur, a_, b_):
        return _contract_with(cur, a_, b_.unsqueeze(0), m, 1, n_bits, True,
                              None, (m, n)).unpack()

    return run_schedule_program(sched, body, (a, b),
                                body_key=("matmul", n_bits),
                                backend=backend, spec=spec, mesh=mesh)


def batched_matmul(a: torch.Tensor, b: Optional[torch.Tensor] = None,
                   n_bits: int = 8, backend: Optional[str] = None,
                   spec: Optional[ArraySpec] = None,
                   b_pack: Optional[PlanePack] = None,
                   mesh=None) -> torch.Tensor:
    """Exact batched intN x intN -> int32 contraction through the CiM array.

    a : int [*B, M, K], b : int [*B, K, N]. The batch dims flatten onto the
    word axis, so every batch element contracts in the SAME
    (2*n_bits - 1) + ceil(log2 K) accesses as a single 2-D matmul; batching
    scales the words (and the tile placement on a `spec`) only."""
    bdims, m, k, bf = _batch_dims(a)
    if b_pack is not None:
        mm, k_pad, n = b_pack.shape
        sched = _place(planner.plan_batched_matmul(
            bf, k_pad, n, n_bits=n_bits, signed=True, resident_rhs=True),
            spec, mm * k_pad * n)

        def body_res(cur, a_, bp):
            return _contract_with(cur, a_.reshape(bf * m, k), None, m, bf,
                                  n_bits, True, bp, bdims + (m, n)).unpack()

        return run_schedule_program(
            sched, body_res, (a, b_pack),
            body_key=("batched_matmul", n_bits, "resident"),
            backend=backend, spec=spec, mesh=mesh)
    n = _check_batched_rhs(a, b, bdims, k)
    k_pad = 1 << planner._log2_ceil(k)
    sched = _place(planner.plan_batched_matmul(bf, k, n, n_bits=n_bits,
                                               signed=True),
                   spec, bf * m * k_pad * n)

    def body(cur, a_, b_):
        return _contract_with(cur, a_.reshape(bf * m, k),
                              b_.reshape(bf, k, n), m, bf, n_bits, True,
                              None, bdims + (m, n)).unpack()

    return run_schedule_program(sched, body, (a, b),
                                body_key=("batched_matmul", n_bits),
                                backend=backend, spec=spec, mesh=mesh)


def _batch_dims(a: torch.Tensor):
    """(batch dims, M, K, flattened batch) of a [*B, M, K] lhs."""
    if a.dim() < 3:
        raise CimOpError(f"batched matmul needs [*B, M, K] lhs, "
                         f"got {tuple(a.shape)}")
    bdims = tuple(int(d) for d in a.shape[:-2])
    bf = 1
    for d in bdims:
        bf *= d
    return bdims, int(a.shape[-2]), int(a.shape[-1]), bf


def _check_batched_rhs(a: torch.Tensor, b: Optional[torch.Tensor],
                       bdims: Tuple[int, ...], k: int) -> int:
    """N of a [*B, K, N] rhs matching the lhs, or CimOpError."""
    if b is None or b.dim() != a.dim() \
            or tuple(int(d) for d in b.shape[:-2]) != bdims \
            or int(b.shape[-2]) != k:
        raise CimOpError(
            f"batched matmul needs [*B,M,K] x [*B,K,N], got {tuple(a.shape)} "
            f"{None if b is None else tuple(b.shape)}")
    return int(b.shape[-1])


def dot(a: torch.Tensor, b: torch.Tensor, n_bits: int = 8,
        backend: Optional[str] = None,
        spec: Optional[ArraySpec] = None, mesh=None) -> torch.Tensor:
    """Exact intN x intN -> int32 dot product of two [K] vectors."""
    return matmul(a.reshape(1, -1), b.reshape(-1, 1), n_bits=n_bits,
                  backend=backend, spec=spec, mesh=mesh)[0, 0]


# ---------------------------------------------------------------------------
# chain executor: one cursor for a fused multi-op region
# ---------------------------------------------------------------------------


class ChainExecutor:
    """Executes a fused region Schedule (`planner.concat_schedules`)
    through ONE shared cursor: each constituent op issues its planned
    accesses in order against the same cursor, so a whole multi-op region
    keeps the per-macro guarantee — ledger accesses == region plan length —
    with every intermediate in the packed domain."""

    def __init__(self, schedule: planner.Schedule,
                 backend: Optional[str] = None,
                 spec: Optional[ArraySpec] = None, mesh=None,
                 charges: Optional[list] = None):
        self.cursor = ScheduleCursor(schedule, backend, spec=spec, mesh=mesh,
                                     charges=charges)

    @classmethod
    def from_cursor(cls, cursor: ScheduleCursor) -> "ChainExecutor":
        """Wrap an already-open cursor (a schedule program's own)."""
        self = cls.__new__(cls)
        self.cursor = cursor
        return self

    # -- single-access ops (one planned step each) --------------------------
    def execute(self, a: PlanePack, b: PlanePack,
                ops: Sequence[str]) -> engine.Outputs:
        return self.cursor.execute(a, b, ops)

    def minimum(self, a: PlanePack, b: PlanePack) -> PlanePack:
        return _minimum_with(self.cursor, a, b)

    def maximum(self, a: PlanePack, b: PlanePack) -> PlanePack:
        return _maximum_with(self.cursor, a, b)

    def abs_(self, a: PlanePack) -> PlanePack:
        return _abs_with(self.cursor, a)

    def neg(self, a: PlanePack) -> PlanePack:
        zero = PlanePack.zeros_like(a)
        return self.cursor.execute(zero, a, ("sub",))["sub"]

    # -- multi-access macros (their planned segment of the region) ----------
    def multiply(self, a: PlanePack, b: PlanePack) -> PlanePack:
        return _multiply_with(self.cursor, a, b)

    def popcount(self, a: PlanePack) -> PlanePack:
        return _popcount_with(self.cursor, a)

    def reduce_sum(self, a: PlanePack) -> PlanePack:
        acc = _reduce_with(self.cursor, a,
                           n_steps=planner._log2_ceil(max(1, a.n_words)))
        return PlanePack(planes=acc.planes, n_bits=acc.n_bits,
                         signed=acc.signed, shape=())

    def matmul(self, a: torch.Tensor, b: Optional[torch.Tensor],
               n_bits: int, signed: bool = True,
               b_pack: Optional[PlanePack] = None) -> PlanePack:
        if a.dim() != 2:
            raise CimOpError(f"matmul needs [M,K] lhs, got {tuple(a.shape)}")
        m, k = (int(d) for d in a.shape)
        if b_pack is not None:
            return _contract_with(self.cursor, a, None, m, 1, n_bits, signed,
                                  b_pack, (m, int(b_pack.shape[2])))
        if b is None or b.dim() != 2 or int(b.shape[0]) != k:
            raise CimOpError(
                f"matmul needs [M,K] x [K,N], got {tuple(a.shape)} "
                f"{None if b is None else tuple(b.shape)}")
        return _contract_with(self.cursor, a, b.unsqueeze(0), m, 1, n_bits,
                              signed, None, (m, int(b.shape[1])))

    def batched_matmul(self, a: torch.Tensor, b: Optional[torch.Tensor],
                       n_bits: int, signed: bool = True,
                       b_pack: Optional[PlanePack] = None) -> PlanePack:
        bdims, m, k, bf = _batch_dims(a)
        a2 = a.reshape(bf * m, k)
        if b_pack is not None:
            return _contract_with(self.cursor, a2, None, m, bf, n_bits,
                                  signed, b_pack,
                                  bdims + (m, int(b_pack.shape[2])))
        n = _check_batched_rhs(a, b, bdims, k)
        return _contract_with(self.cursor, a2, b.reshape(bf, k, n), m, bf,
                              n_bits, signed, None, bdims + (m, n))

    def finish(self) -> None:
        self.cursor.finish()


# ---------------------------------------------------------------------------
# integer-level convenience wrappers (pack at entry, unpack at exit)
# ---------------------------------------------------------------------------


def multiply_ints(x: torch.Tensor, y: torch.Tensor, n_bits: int = 16,
                  signed: bool = True, backend: Optional[str] = None,
                  spec: Optional[ArraySpec] = None, mesh=None) -> torch.Tensor:
    return multiply(PlanePack.pack(x, n_bits, signed=signed),
                    PlanePack.pack(y, n_bits, signed=signed),
                    backend=backend, spec=spec, mesh=mesh).unpack()


def relu_ints(x: torch.Tensor, n_bits: int = 16,
              backend: Optional[str] = None,
              spec: Optional[ArraySpec] = None, mesh=None) -> torch.Tensor:
    return relu(PlanePack.pack(x, n_bits), backend=backend,
                spec=spec, mesh=mesh).unpack()


def abs_ints(x: torch.Tensor, n_bits: int = 16,
             backend: Optional[str] = None,
             spec: Optional[ArraySpec] = None, mesh=None) -> torch.Tensor:
    return abs_(PlanePack.pack(x, n_bits), backend=backend,
                spec=spec, mesh=mesh).unpack()


def minimum_ints(x: torch.Tensor, y: torch.Tensor, n_bits: int = 16,
                 backend: Optional[str] = None,
                 spec: Optional[ArraySpec] = None, mesh=None) -> torch.Tensor:
    return minimum(PlanePack.pack(x, n_bits), PlanePack.pack(y, n_bits),
                   backend=backend, spec=spec, mesh=mesh).unpack()


def maximum_ints(x: torch.Tensor, y: torch.Tensor, n_bits: int = 16,
                 backend: Optional[str] = None,
                 spec: Optional[ArraySpec] = None, mesh=None) -> torch.Tensor:
    return maximum(PlanePack.pack(x, n_bits), PlanePack.pack(y, n_bits),
                   backend=backend, spec=spec, mesh=mesh).unpack()


def popcount_ints(x: torch.Tensor, n_bits: int = 16,
                  backend: Optional[str] = None,
                  spec: Optional[ArraySpec] = None, mesh=None) -> torch.Tensor:
    return popcount(PlanePack.pack(x, n_bits), backend=backend,
                    spec=spec, mesh=mesh).unpack()


def reduce_sum_ints(x: torch.Tensor, n_bits: int = 16, signed: bool = True,
                    backend: Optional[str] = None,
                    spec: Optional[ArraySpec] = None, mesh=None) -> torch.Tensor:
    return reduce_sum(PlanePack.pack(x, n_bits, signed=signed),
                      backend=backend, spec=spec, mesh=mesh).unpack()
