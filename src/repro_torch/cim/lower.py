"""The aten -> CiM lowering compiler: offload estimates become execution.

Port of `repro.cim.lower`. `lower(fn)` turns an unmodified PyTorch function
into a hybrid callable:

  1. `repro_torch.cim.trace` captures the function as an aten graph and
     classifies every node (single-access / multi-access / free
     peripheral / host).
  2. Maximal runs of eligible nodes become fused REGIONS. Each region's
     per-op schedules are concatenated (planner.concat_schedules) into ONE
     region Schedule and run by macro.run_schedule_program as ONE
     dispatch: every access of every fused op, the packed-domain
     peripherals between them, the entry packs and the exit unpacks.
     Chained eligible ops share the program's cursor (a ChainExecutor over
     it) and their intermediates stay in the PlanePack packed domain with
     zero pack/unpack between them. Region programs live in the dispatch
     layer's bounded LRU under a STRUCTURAL key (canonicalized dataflow +
     operand signatures), so repeated regions hit; ledger charges replay
     from the first run's PlannedCharges record.
  3. Everything else runs on the host, node by node, on the arguments'
     device, as the captured graph would. After each item the interpreter
     drops the values no later item reads (for a region, its dead inputs,
     never the caller's tensors), as an eager run frees its temporaries,
     so the caching allocator can reuse their memory.

The hybrid callable is bit-exact with the original function: every CiM op
result is truncated/extended to its node's output dtype in the packed
domain, so int8 wrap-around, unsigned arithmetic and bool predicates all
match torch's integer semantics.

Cost model contract: the region schedules ARE the cost. An unbanked run
charges the ledger exactly `sum(region.schedule.accesses)` accesses. With
an ArraySpec, every access tiles over banks through repro_torch.cim.dispatch
and the ledger charges per (device, bank) activations instead.

The one declared exception to zero-repack: a contraction consumes
materialized integer operands (the broadcast [M, K_pad, N] layout has to be
built, as in macro.matmul), so a packed in-region operand feeding it is
unpacked first. A free convert/reshape whose operand is not yet packed is
computed on integers (`x.to(dtype)`, `x.reshape(...)`, the same two's-
complement values the packed truncate/extend gives) and charged the entry
load its packed form would have paid: a contraction's int32 region inputs
then cost their loads without a 32-plane pack and unpack per call, and an
elementwise consumer packs the value (no second charge) when it needs it.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.fx import Node

from . import array as array_mod
from . import cost as cost_mod
from . import macro, planner
from . import trace as trace_mod
from .array import ArraySpec
from .opset import CimOpError
from .planepack import PlanePack
from .trace import (CMP_PRIMS, ConstVal, Literal, TracedOp, aval_of,
                    dtype_bits, dtype_signed)


# ---------------------------------------------------------------------------
# packed-domain helpers (all zero-access peripheral wiring)
# ---------------------------------------------------------------------------

_PAD_MASKS: Dict[Tuple[int, int, Any], torch.Tensor] = {}


def _pad_mask(n_words: int, lanes: int, device) -> torch.Tensor:
    key = (n_words, lanes, device)
    m = _PAD_MASKS.get(key)
    if m is None:
        m = torch.zeros(lanes, dtype=torch.int32, device=device)
        full, rem = divmod(n_words, 32)
        m[:full] = -1                       # 0xFFFFFFFF held in int32
        if rem:
            m[full] = (1 << rem) - 1
        _PAD_MASKS[key] = m
    return m


def _mask_pad(pack: PlanePack) -> PlanePack:
    """Zero the bit positions past the last logical word. Every region
    result is masked so packs feeding shifts/reductions keep the zero-pad
    invariant (an `eq` bitmap, say, reads 1 on pad words)."""
    lanes = pack.planes.shape[1]
    if pack.n_words >= lanes * 32:
        return pack
    mask = _pad_mask(pack.n_words, lanes, pack.planes.device)
    return dataclasses.replace(pack, planes=pack.planes & mask[None, :])


def _to_width(pack: PlanePack, bits: int, signed: bool) -> PlanePack:
    if pack.n_bits > bits:
        pack = pack.truncate_to(bits)
    elif pack.n_bits < bits:
        pack = pack.extend_to(bits)      # fill follows the pack's signedness
    return pack.as_signed(signed)


def _finish(pack: PlanePack, aval) -> PlanePack:
    """Land an op result on its output aval: width/signedness per dtype
    (two's-complement wrap, torch's integer cast semantics), logical shape,
    pad bits cleared."""
    pack = _to_width(pack, dtype_bits(aval.dtype), dtype_signed(aval.dtype))
    pack = dataclasses.replace(pack, shape=tuple(aval.shape))
    return _mask_pad(pack)


def _complement(pack: PlanePack) -> PlanePack:
    """Bitwise NOT of every plane: the SA output complement, free wiring."""
    return dataclasses.replace(pack, planes=~pack.planes)


def _broadcast_pack(pack: PlanePack, shape: Tuple[int, ...]) -> PlanePack:
    """Scalar pack -> `shape`: the row buffer fanning one word out."""
    if pack.n_words != 1:
        raise CimOpError(f"can only broadcast scalar packs, got {pack.shape}")
    n = 1
    for d in shape:
        n *= int(d)
    return pack.take_words(torch.zeros(n, dtype=torch.int64,
                                       device=pack.planes.device),
                           tuple(shape))


def _is_var(atom) -> bool:
    return isinstance(atom, Node)


# ---------------------------------------------------------------------------
# regions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResidentAtom:
    """One region input pinnable in the resident region.

    ai      : index into the region's in_atoms.
    kind    : "matmul_rhs" — every in-region consumer is a contraction
              with this atom as its rhs, so the pinned stack is the
              expanded [M, K_pad, N] entry pack (macro.matmul_rhs_pack) and
              warm calls skip the rhs expansion AND pack entirely;
              "batched_matmul_rhs" — the batched analogue
              ([B_flat * M, K_pad, N], macro.batched_matmul_rhs_pack):
              attention's K^T / V sides;
              "pack" — the atom's plain entry pack is pinned and seeded
              into the region's pack env.
    n_words : logical words of the pinned pack (fit checks + charges).
    m       : *matmul_rhs only — the per-batch lhs row count baked into
              the pack.
    chain_eqns : *matmul_rhs only — region op indices of the zero-access
              pass-through chain (convert/reshape) between the atom and
              the contraction's rhs: replayed on the host when pinning,
              skipped in the resident region body.
    """

    ai: int
    kind: str
    n_bits: int
    signed: bool
    n_words: int
    m: int = 0
    chain_eqns: Tuple[int, ...] = ()


@dataclasses.dataclass
class Region:
    """A maximal run of eligible ops fused into one Schedule.

    `in_atoms` are the region program's inputs (external Nodes + graph
    constants, in first-use order; scalars are baked into the body).
    `donatable` indexes the in_atoms that are dead after the region: the
    interpreter drops them once the region has run. `key` is the
    structural cache key: dataflow with canonicalized node numbering plus
    operand signatures, so two structurally identical regions share one
    program.

    `resident` (set by residency planning) names the in_atoms whose entry
    packs are pinned across calls; `schedule_resident` is the same step
    plan with those operand sides named resident — a different Schedule
    value, so resident and streamed runs of one region occupy different
    program-cache slots by construction."""

    name: str
    ops: List[TracedOp]
    schedule: planner.Schedule
    unpack_vars: Tuple[Any, ...] = ()   # outputs a host consumer needs
    in_atoms: Tuple[Any, ...] = ()
    donatable: Tuple[int, ...] = ()
    key: Tuple = ()
    index: int = 0
    resident: Tuple[ResidentAtom, ...] = ()
    schedule_resident: Optional[planner.Schedule] = None
    donatable_resident: Tuple[int, ...] = ()

    @property
    def accesses(self) -> int:
        return self.schedule.accesses


def _region_in_atoms(region: Region) -> Tuple[Any, ...]:
    """External operands of a region, in first-use order: Nodes produced
    outside it plus graph constants (deduped; scalars stay baked in)."""
    produced = {v for op in region.ops for v in op.outvars}
    atoms: List[Any] = []
    seen: set = set()
    for op in region.ops:
        for a in op.invars:
            if _is_var(a):
                if a not in produced and a not in seen:
                    seen.add(a)
                    atoms.append(a)
            elif isinstance(a, ConstVal):
                if id(a) not in seen:
                    seen.add(id(a))
                    atoms.append(a)
    return tuple(atoms)


#: shared cache-key signature discipline (ONE definition, see macro.aval_sig)
_aval_sig = macro.aval_sig


def _region_key(region: Region) -> Tuple:
    """Structural identity of a region's computation.

    Nodes (and graph constants — their VALUES are program inputs, not
    baked constants) are numbered by first appearance, scalars are hashed
    by content; together with op names and operand/result signatures this
    determines the region body exactly, so structurally identical regions
    may share one program."""
    ids: Dict[int, int] = {}

    def ref(v) -> int:
        return ids.setdefault(id(v), len(ids))

    parts: List[Tuple] = [
        ("in",) + tuple((ref(a), _aval_sig(aval_of(a)))
                        for a in region.in_atoms)]
    for op in region.ops:
        ins = []
        for a in op.invars:
            if isinstance(a, Literal):
                ins.append(("lit", repr(a.val), _aval_sig(a.aval)))
            else:
                ins.append(("v", ref(a), _aval_sig(aval_of(a))))
        outs = tuple(("v", ref(v), _aval_sig(aval_of(v)))
                     for v in op.outvars)
        parts.append((op.name, tuple(ins), outs))
    parts.append(("out",) + tuple(ref(v) for v in region.unpack_vars))
    return tuple(parts)


#: consumers whose getp() call always uses the operand's OWN aval shape
#: (unary source-shape reads): safe for a penv-seeded resident pack
_SRC_SHAPE_OPS = ("reduce_sum", "convert_element_type", "reshape",
                  "broadcast_in_dim")


def _classify_resident(region: Region, ai: int, atom) -> \
        Optional[ResidentAtom]:
    """How (and whether) one derived region input can be pinned.

    "matmul_rhs" when the atom — possibly through a chain of zero-access
    unary pass-throughs (convert/reshape) with no other consumers — is
    consumed only by contractions taking it as rhs with one consistent
    (M, n_bits, signedness): the expanded broadcast pack is then pinnable,
    the chain ops are replayed on the host once at pin time and skipped in
    the resident body, and the warm path skips the whole rhs build.
    Otherwise "pack" when every consumer reads the atom at its own aval
    shape (or through an unpack): the plain entry pack seeds the region's
    pack env. None when the consumption pattern would need a per-call
    repack anyway (e.g. non-scalar broadcast into a wider shape)."""
    aval = aval_of(atom)
    consumers = [op for op in region.ops
                 if any(a is atom for a in op.invars)]
    if not consumers:                      # pragma: no cover
        return None
    frontier = atom
    chain_eqns: List[int] = []
    mk = None
    rhs_only = True
    while True:
        cons = [(ei, op) for ei, op in enumerate(region.ops)
                if any(a is frontier for a in op.invars)]
        if not cons:
            rhs_only = False
            break
        if all(op.name == "dot_general" and op.invars[1] is frontier
               and op.invars[0] is not frontier for _, op in cons):
            for _, op in cons:
                lhs_aval = aval_of(op.invars[0])
                nb = len(lhs_aval.shape) - 2
                sig = (nb, tuple(int(d) for d in lhs_aval.shape[:-1]),
                       op.n_bits, dtype_signed(lhs_aval.dtype))
                if mk is None:
                    mk = sig
                elif mk != sig:
                    rhs_only = False
                    break
            break
        ei, op = cons[0]
        if len(cons) != 1 \
                or op.name not in ("convert_element_type", "reshape") \
                or op.invars[0] is not frontier \
                or op.outvars[0] in region.unpack_vars:
            rhs_only = False
            break
        chain_eqns.append(ei)
        frontier = op.outvars[0]
    f_aval = aval_of(frontier)
    if rhs_only and mk is not None and len(f_aval.shape) == mk[0] + 2:
        nb, lead, n_bits, signed = mk
        # `lead` is the lhs's [*B, M]; the pinned stack holds one expanded
        # [K_pad, N] block per (batch, m) row
        rows = 1
        for d in lead:
            rows *= d
        m = lead[-1]
        k, n = int(f_aval.shape[-2]), int(f_aval.shape[-1])
        k_pad = 1 << planner._log2_ceil(k)
        return ResidentAtom(ai=ai,
                            kind="batched_matmul_rhs" if nb else "matmul_rhs",
                            n_bits=n_bits, signed=signed,
                            n_words=rows * k_pad * n, m=m,
                            chain_eqns=tuple(chain_eqns))
    n_words = 1
    for d in aval.shape:
        n_words *= int(d)
    for op in consumers:
        if op.name == "dot_general" or (op.name in _SRC_SHAPE_OPS
                                        and op.invars[0] is atom):
            continue
        out_shape = tuple(aval_of(op.outvars[0]).shape)
        if out_shape != tuple(aval.shape) and n_words != 1:
            return None    # would repack at the broadcast shape per call
    return ResidentAtom(ai=ai, kind="pack",
                        n_bits=dtype_bits(aval.dtype),
                        signed=dtype_signed(aval.dtype), n_words=n_words)


def _read_host(env: Dict[Any, Any], atom, device=None):
    if isinstance(atom, Literal):
        return torch.tensor(atom.val, dtype=atom.aval.dtype, device=device)
    if isinstance(atom, ConstVal):
        val = atom.val
        if device is not None and val.device != torch.device(device) \
                and val.dim():
            val = val.to(device)
        return val
    if isinstance(atom, Node):
        return env[atom]
    return atom                          # a Python scalar output


class LoweredComputation:
    """One captured-and-planned lowering of a function at fixed argument
    signatures.

    `execute(*args)` runs the hybrid program; `describe()` prints the
    region structure and fused schedules; `accesses` is the exact unbanked
    ledger charge of one execution.
    """

    def __init__(self, tr: trace_mod.Trace,
                 backend: Optional[str] = None,
                 spec: Optional[ArraySpec] = None,
                 resident_leaf_idx: Tuple[int, ...] = (),
                 resident_set=None, policy: Optional[str] = None,
                 device=None, mesh=None):
        self.trace = tr
        self.backend = backend
        self.spec = spec
        self.mesh = mesh
        self.resident_leaf_idx = tuple(resident_leaf_idx)
        # resident_set=None -> the registry set for `spec`: resolved fresh
        # on every execute (clear_resident() replaces the registry object;
        # a stale capture would pin into a dropped set), and once here for
        # the construction-time residency budget planning
        self._registry_rs = resident_set is None
        if resident_set is None and self.resident_leaf_idx:
            resident_set = array_mod.resident_set(spec)
        self.resident_set = resident_set
        # the cost model decides, per eligible op, whether lowering pays
        # under `policy` (repro_torch.cim.cost); demoted ops run on host
        self.offload_plan = cost_mod.plan_offload(
            tr, spec=spec, device=device, policy=policy)
        self.policy = self.offload_plan.policy
        self.items: List[Tuple[str, Any]] = []
        self.regions: List[Region] = []
        self._warm_skip: frozenset = frozenset()
        self._build()
        self._plan_residency()

    # -- structure ----------------------------------------------------------
    def _build(self) -> None:
        items: List[Tuple[str, Any]] = []
        buf: List[TracedOp] = []

        def flush():
            if not buf:
                return
            scheds = [o.schedule for o in buf if o.schedule is not None]
            if not scheds or sum(s.accesses for s in scheds) == 0:
                # a run of purely-free ops does no array work: host it
                items.extend(("host", o) for o in buf)
            else:
                # the schedule's macro name is deliberately NOT positional:
                # it is part of the program-cache key, and structurally
                # identical regions (e.g. repeated layers) must share one
                # program; Region.name keeps the position for display
                region = Region(name=f"region{len(self.regions)}",
                                ops=list(buf),
                                schedule=planner.concat_schedules(
                                    scheds, macro="region"),
                                index=len(self.regions))
                self.regions.append(region)
                items.append(("region", region))
            buf.clear()

        demoted = self.offload_plan.demoted
        for i, op in enumerate(self.trace.ops):
            if op.eligible and i not in demoted:
                buf.append(op)
            else:
                flush()
                items.append(("host", op))
        flush()
        self.items = items

        # which region outputs must materialize for host consumers / outputs
        out_roots = {v for v in self.trace.outvars if _is_var(v)}
        consumed_after: List[set] = [set() for _ in items]
        acc: set = set(out_roots)
        for i in range(len(items) - 1, -1, -1):
            consumed_after[i] = set(acc)
            kind, payload = items[i]
            ops = payload.ops if kind == "region" else [payload]
            for op in ops:
                acc.update(v for v in op.invars if _is_var(v))
        caller_owned = set(self.trace.invars)
        # host items drop the values they touch that nothing later reads,
        # as an eager run frees its temporaries (regions drop `donatable`)
        self._host_dead = [
            tuple(v for v in set(a for a in payload.invars if _is_var(a))
                  | set(payload.outvars)
                  if v not in consumed_after[i] and v not in out_roots)
            if kind == "host" else () for i, (kind, payload)
            in enumerate(items)]
        for i, (kind, payload) in enumerate(items):
            if kind == "region":
                payload.unpack_vars = tuple(
                    v for op in payload.ops for v in op.outvars
                    if v in consumed_after[i])
                payload.in_atoms = _region_in_atoms(payload)
                # inputs dead after this region, never the caller's own
                # tensors: the interpreter drops them after the region
                payload.donatable = tuple(
                    j for j, a in enumerate(payload.in_atoms)
                    if _is_var(a) and a not in caller_owned
                    and a not in consumed_after[i])
                payload.key = _region_key(payload)

    # -- residency planning -------------------------------------------------
    def _plan_residency(self) -> None:
        """Decide, statically, which region inputs can live in array rows.

        A region input is resident-eligible when its value is DERIVED purely
        from the resident arguments (seeded at the graph's inputs,
        propagated through ops whose every node input is itself derived —
        graph constants and scalars are call-invariant and never block),
        its in-region consumption pattern admits a pinnable entry pack, and
        that pack's rows fit the empty resident budget of the ResidentSet's
        geometry (an oversize atom silently stays streamed). The warm-skip
        set then marks host ops that exist ONLY to produce resident-derived
        values: with every pin warm the executor skips them."""
        rs = self.resident_set
        if rs is None or not self.resident_leaf_idx:
            return
        derived = {self.trace.invars[i] for i in self.resident_leaf_idx}
        for op in self.trace.ops:
            vars_in = [a for a in op.invars if _is_var(a)]
            if all(v in derived for v in vars_in):
                derived.update(op.outvars)
        budget = rs.spec.rows - rs.reserve_rows
        for region in self.regions:
            resident: List[ResidentAtom] = []
            for ai, atom in enumerate(region.in_atoms):
                if not _is_var(atom) or atom not in derived:
                    continue
                ra = _classify_resident(region, ai, atom)
                if ra is None:
                    continue
                rows = rs._rows_for(ra.n_bits, ra.n_words)
                if max(rows.values(), default=0) > budget:
                    continue
                resident.append(ra)
            if resident:
                region.resident = tuple(resident)
                names = tuple(f"in{ra.ai}" for ra in resident)
                region.schedule_resident = region.schedule \
                    .with_operands(*names).with_resident(*names)
                rset = {ra.ai for ra in resident}
                region.donatable_resident = tuple(
                    j for j in region.donatable if j not in rset)
        if not any(r.resident for r in self.regions):
            return
        needed = {v for v in self.trace.outvars if _is_var(v)}
        skip = set()
        for i in range(len(self.items) - 1, -1, -1):
            kind, payload = self.items[i]
            if kind == "region":
                rset = {ra.ai for ra in payload.resident}
                needed.update(
                    a for j, a in enumerate(payload.in_atoms)
                    if _is_var(a) and j not in rset)
            else:
                if not any(v in needed for v in payload.outvars):
                    skip.add(i)
                else:
                    needed.update(v for v in payload.invars if _is_var(v))
        self._warm_skip = frozenset(skip)

    def _build_resident_pack(self, region: Region, ra: ResidentAtom,
                             value: torch.Tensor) -> PlanePack:
        """The concrete plane stack a ResidentSet pins for one atom,
        bitwise identical to what the region body would build per call."""
        arr = value
        if ra.kind in ("matmul_rhs", "batched_matmul_rhs"):
            # replay the skipped pass-through chain on the host: these are
            # the ops between the region input and the contraction's rhs
            for ei in ra.chain_eqns:
                op = region.ops[ei]
                oav = aval_of(op.outvars[0])
                if op.name == "convert_element_type":
                    arr = arr.to(oav.dtype)
                else:
                    arr = arr.reshape(tuple(oav.shape))
            if ra.kind == "batched_matmul_rhs":
                return macro.batched_matmul_rhs_pack(arr, ra.m, ra.n_bits,
                                                     signed=ra.signed)
            return macro.matmul_rhs_pack(arr, ra.m, ra.n_bits,
                                         signed=ra.signed)
        if arr.dtype == torch.bool:
            arr = arr.to(torch.int32)
        return PlanePack.pack(arr, ra.n_bits, signed=ra.signed)

    # -- execution ----------------------------------------------------------
    def execute(self, *args):
        leaves, _ = trace_mod.flatten_args(args)
        invars = self.trace.invars
        if len(leaves) != len(invars):
            raise CimOpError(
                f"lowered function takes {len(invars)} tensor leaves, "
                f"got {len(leaves)}")
        device = leaves[0].device if leaves else None
        env: Dict[Any, Any] = dict(zip(invars, leaves))

        rs = self.resident_set
        if self._registry_rs and self.resident_leaf_idx:
            # registry-backed: re-resolve each call so clear_resident() and
            # spec swaps take effect on the next execution instead of
            # pinning into a stale set
            rs = array_mod.resident_set(self.spec)
        resident_on = (rs is not None and self.resident_leaf_idx
                       and any(r.resident for r in self.regions))
        fp = None
        keep = None
        warm = False
        if resident_on:
            # the fingerprint is PART of the key: one LoweredComputation is
            # shared by every caller with these signatures (e.g. identical
            # layers of a stack), and each caller's weights deserve their
            # own pin. The entry keeps strong refs (aux) to the
            # fingerprinted tensors and this computation, so a recycled
            # id() can never alias.
            fp = tuple(id(leaves[i]) for i in self.resident_leaf_idx)
            keep = tuple(leaves[i] for i in self.resident_leaf_idx) + (self,)
            warm = all(
                rs.peek(("lowered", id(self), r.index, ra.ai) + fp, fp)
                for r in self.regions for ra in r.resident)

        for i, (kind, payload) in enumerate(self.items):
            if kind == "host":
                if not (warm and i in self._warm_skip):
                    self._run_host(payload, env, device)
                for v in self._host_dead[i]:
                    env.pop(v, None)
                continue
            rmap = None
            if resident_on and payload.resident:
                rmap = {}
                for ra in payload.resident:
                    key = ("lowered", id(self), payload.index, ra.ai) + fp
                    entry = rs.get(key, fingerprint=fp)
                    if entry is None:
                        value = _read_host(env, payload.in_atoms[ra.ai],
                                           device)
                        entry = rs.pin(
                            key,
                            self._build_resident_pack(payload, ra, value),
                            fingerprint=fp, aux=keep)
                    rmap[ra.ai] = entry.pack
            self._run_region(payload, env, device, resident_map=rmap)
        outs = [_read_host(env, v, device) for v in self.trace.outvars]
        return trace_mod.pytree.tree_unflatten(outs, self.trace.out_spec)

    __call__ = execute

    def _run_host(self, op: TracedOp, env: Dict[Any, Any], device) -> None:
        node = op.node
        subst = self.trace.subst

        def read(n: Node):
            return _read_host(env, subst.get(n, n), device)

        args, kwargs = torch.fx.node.map_arg((node.args, node.kwargs), read)
        env[node] = node.target(*args, **kwargs)

    def _run_region(self, region: Region, env: Dict[Any, Any], device,
                    resident_map: Optional[Dict[int, PlanePack]] = None
                    ) -> None:
        """Execute a fused region as ONE schedule program: gather the
        region's input leaves from the host env, invoke (or record) the
        cached program, land the unpacked outputs back in the env, and drop
        the env's references to the region's dead inputs.

        With `resident_map` (atom index -> pinned PlanePack) the resident
        atoms enter the program AS plane stacks — their raw values are
        never read, their entry packs never rebuilt — under the resident
        schedule and a resident-marked body key, so streamed and resident
        runs of one region never share a program."""
        leaves = tuple(
            resident_map[j] if resident_map and j in resident_map
            else _read_host(env, a, device)
            for j, a in enumerate(region.in_atoms))
        if resident_map:
            schedule = region.schedule_resident
            body_key = ("region", region.key,
                        ("resident",) + region.resident)
            dead = region.donatable_resident
            body = self._region_body(region, device, frozenset(resident_map))
        else:
            schedule = region.schedule
            body_key = ("region", region.key)
            dead = region.donatable
            body = self._region_body(region, device)
        outs = macro.run_schedule_program(
            schedule, body, leaves, body_key=body_key, backend=self.backend,
            spec=self.spec, mesh=self.mesh)
        del leaves
        for j in dead:
            env.pop(region.in_atoms[j], None)
        for var, val in zip(region.unpack_vars, outs):
            env[var] = val

    def _region_body(self, region: Region, device,
                     resident_ais: frozenset = frozenset()):
        """The region computation `run_schedule_program` runs: the per-op
        execution loop over the program's shared cursor."""
        resident_kinds = {ra.ai: ra for ra in region.resident
                          if ra.ai in resident_ais}
        # ops replayed into the pinned pack at pin time: dead in the body
        skip_eqns = frozenset(ei for ra in resident_kinds.values()
                              for ei in ra.chain_eqns)
        # the region's scalar literals as device tensors, made at the
        # program's first (eager) call and kept: a CUDA graph cannot copy
        # host values to the device at its capture
        literals: Dict[int, torch.Tensor] = {}

        def body(cur, *leaves):
            chain = macro.ChainExecutor.from_cursor(cur)
            var_env: Dict[Any, Any] = {}
            const_env: Dict[int, Any] = {}
            resident_matmul: Dict[Any, PlanePack] = {}
            penv: Dict[Any, PlanePack] = {}
            # integer values of region values not (yet) packed: entry
            # operands already charged, and free convert/reshape results
            ienv: Dict[Any, torch.Tensor] = {}
            for j, (atom, leaf) in enumerate(zip(region.in_atoms, leaves)):
                ra = resident_kinds.get(j)
                if ra is not None:
                    if ra.kind in ("matmul_rhs", "batched_matmul_rhs"):
                        # keyed at the END of the pass-through chain: the
                        # node the contraction consumes; the reuse charge
                        # lands inside _contract_with
                        fvar = region.ops[ra.chain_eqns[-1]].outvars[0] \
                            if ra.chain_eqns else atom
                        resident_matmul[fvar] = leaf
                    else:
                        penv[atom] = leaf     # pre-seeded entry pack
                        cur.charge_resident(leaf.n_bits, leaf.n_words)
                elif isinstance(atom, ConstVal):
                    const_env[id(atom)] = leaf
                else:
                    var_env[atom] = leaf

            def read(atom):
                if isinstance(atom, Literal):
                    lit = literals.get(id(atom))
                    if lit is None:
                        lit = literals[id(atom)] = torch.tensor(
                            atom.val, dtype=atom.aval.dtype, device=device)
                    return lit
                if isinstance(atom, ConstVal):
                    return const_env[id(atom)]
                return var_env[atom]

            def as_ints(x: torch.Tensor) -> torch.Tensor:
                return x.to(torch.int32) if x.dtype == torch.bool else x

            def getp(atom, shape) -> PlanePack:
                """Operand as a PlanePack of logical `shape` (region entry
                pack for external values — each packed ONCE per region —
                with scalar fanout staying in the packed domain)."""
                shape = tuple(shape)
                if _is_var(atom) and atom not in penv and atom in ienv:
                    # charged already (entry operand or free result of one)
                    aval = aval_of(atom)
                    penv[atom] = PlanePack.pack(
                        as_ints(ienv[atom]), dtype_bits(aval.dtype),
                        signed=dtype_signed(aval.dtype))
                if _is_var(atom) and atom in penv:
                    p = penv[atom]
                    if p.shape != shape:
                        p = _broadcast_pack(p, shape)
                    return p
                aval = aval_of(atom)
                arr = as_ints(read(atom))
                if tuple(arr.shape) != shape:
                    arr = torch.broadcast_to(arr, shape)
                p = PlanePack.pack(arr, dtype_bits(aval.dtype),
                                   signed=dtype_signed(aval.dtype))
                # a freshly built entry pack is a STREAMED operand load:
                # its planes are driven into rows before the first access
                # (resident atoms never reach here: they are pre-seeded)
                cur.charge_load(p.n_bits, p.n_words)
                if _is_var(atom) and shape == tuple(aval.shape):
                    penv[atom] = p    # entry pack: reused by later consumers
                return p

            def entry_ints(atom) -> torch.Tensor:
                """Operand of a free convert/reshape as integers, charged
                as the entry pack `getp` would build at its own shape."""
                if _is_var(atom) and atom in ienv:
                    return ienv[atom]
                aval = aval_of(atom)
                x = read(atom)
                n = 1
                for d in aval.shape:
                    n *= int(d)
                cur.charge_load(dtype_bits(aval.dtype), n)
                if _is_var(atom):
                    ienv[atom] = x
                return x

            def geti(atom) -> torch.Tensor:
                """Operand as an integer tensor (the contraction layout
                rebuild: the one declared in-region materialization)."""
                if _is_var(atom) and atom in ienv:
                    return ienv[atom]
                if _is_var(atom) and atom in penv:
                    return penv[atom].unpack().to(aval_of(atom).dtype)
                return read(atom)

            for ei, op in enumerate(region.ops):
                if ei in skip_eqns:
                    continue
                out_aval = aval_of(op.outvars[0])
                shape = tuple(out_aval.shape)
                name = op.name
                src = op.invars[0]
                if name in ("convert_element_type", "reshape") \
                        and not (_is_var(src) and src in penv):
                    x = entry_ints(src)
                    ienv[op.outvars[0]] = x.to(out_aval.dtype) \
                        if name == "convert_element_type" \
                        else x.reshape(shape)
                    continue
                if name in ("add", "sub", "and", "or", "xor"):
                    pa = getp(op.invars[0], shape)
                    pb = getp(op.invars[1], shape)
                    res = chain.execute(pa, pb, (name,))[name]
                elif name in CMP_PRIMS:
                    base, complement = CMP_PRIMS[name]
                    pa = getp(op.invars[0], shape)
                    pb = getp(op.invars[1], shape)
                    res = chain.execute(pa, pb, (base,))[base]
                    if complement:
                        res = _complement(res)
                elif name == "min":
                    res = chain.minimum(getp(op.invars[0], shape),
                                        getp(op.invars[1], shape))
                elif name == "max":
                    res = chain.maximum(getp(op.invars[0], shape),
                                        getp(op.invars[1], shape))
                elif name == "neg":
                    res = chain.neg(getp(op.invars[0], shape))
                elif name == "abs":
                    res = chain.abs_(getp(op.invars[0], shape))
                elif name == "mul":
                    res = chain.multiply(getp(op.invars[0], shape),
                                         getp(op.invars[1], shape))
                elif name == "population_count":
                    res = chain.popcount(getp(op.invars[0], shape))
                elif name == "reduce_sum":
                    src_shape = tuple(aval_of(src).shape)
                    res = chain.reduce_sum(getp(src, src_shape))
                elif name == "dot_general":
                    rb = resident_matmul.get(op.invars[1]) \
                        if _is_var(op.invars[1]) else None
                    nb = len(aval_of(src).shape) - 2
                    mm = chain.batched_matmul if nb else chain.matmul
                    res = mm(geti(src),
                             None if rb is not None else geti(op.invars[1]),
                             op.n_bits, signed=dtype_signed(aval_of(src).dtype),
                             b_pack=rb)
                elif name in ("convert_element_type", "reshape"):
                    res = getp(src, tuple(aval_of(src).shape))
                elif name == "not":
                    res = _complement(getp(src, shape))
                elif name == "select_n":
                    # where(pred, x, y) reads pred ? x : y (the reference's
                    # select_n lists the false case first)
                    res = macro.select(getp(op.invars[0], shape),
                                       getp(op.invars[1], shape),
                                       getp(op.invars[2], shape))
                elif name == "broadcast_in_dim":
                    res = _broadcast_pack(
                        getp(src, tuple(aval_of(src).shape)), shape)
                else:                             # pragma: no cover
                    raise CimOpError(f"region executor missing op {name!r}")
                penv[op.outvars[0]] = _finish(res, out_aval)

            return tuple(ienv[var] if var in ienv
                         else penv[var].unpack().to(aval_of(var).dtype)
                         for var in region.unpack_vars)

        return body

    # -- reporting ----------------------------------------------------------
    @property
    def accesses(self) -> int:
        """Planned (== executed, unbanked) ADRA accesses per call."""
        return sum(r.accesses for r in self.regions)

    @property
    def eligible_eqns(self) -> int:
        return sum(len(r.ops) for r in self.regions)

    @property
    def host_eqns(self) -> int:
        return sum(1 for kind, _ in self.items if kind == "host")

    def describe(self) -> str:
        plan = self.offload_plan
        lines = [f"lowered: {len(self.regions)} CiM region(s), "
                 f"{self.host_eqns} host op(s), "
                 f"{self.accesses} planned accesses "
                 f"[policy={plan.policy}, {plan.demoted_eqns} demoted, "
                 f"{plan.fused_losses} kept fused despite loss]"]
        for v in plan.verdicts:
            if v.index in plan.demoted:
                lines.append(f"  demoted op#{v.index} {v.name} "
                             f"({v.accesses} accesses): {v.reason} "
                             f"(margin {100 * v.margin:+.1f}%)")
        for r in self.regions:
            segs = ", ".join(f"{name}:{n}" for name, n in
                             (r.schedule.segments or ()))
            lines.append(f"  {r.name}: {len(r.ops)} ops fused -> "
                         f"{r.accesses} accesses [{segs}]")
        return "\n".join(lines)


#: per-function bound on cached signature captures: a long-lived server fed
#: ever-varying shapes must not grow a LoweredFunction without limit
SIGNATURE_CACHE_CAPACITY = 128


class LoweredFunction:
    """`lower(fn)`: captures lazily per argument signature and executes the
    hybrid CiM/host program. The signature cache is a bounded LRU
    (SIGNATURE_CACHE_CAPACITY); an evicted signature simply recaptures."""

    def __init__(self, fn, backend: Optional[str] = None,
                 spec: Optional[ArraySpec] = None,
                 resident_argnums: Tuple[int, ...] = (),
                 resident_set=None, policy: Optional[str] = None,
                 device=None, mesh=None):
        self.fn = fn
        self.backend = backend
        self.spec = spec
        self.mesh = mesh
        self.resident_argnums = tuple(resident_argnums)
        self.resident_set = resident_set
        self.policy = cost_mod.normalize_policy(policy)
        self.device = device
        self._cache: "OrderedDict[Any, LoweredComputation]" = OrderedDict()

    def _resident_leaf_idx(self, args) -> Tuple[int, ...]:
        """Flat leaf indices of the resident argnums (the positions
        `execute` fingerprints and the residency planner seeds from)."""
        if not self.resident_argnums:
            return ()
        spans = []
        start = 0
        for a in args:
            n = len(trace_mod.pytree.tree_leaves(a))
            spans.append((start, start + n))
            start += n
        idx: List[int] = []
        for an in self.resident_argnums:
            if an < len(spans):
                idx.extend(range(*spans[an]))
        return tuple(idx)

    def trace(self, *args) -> LoweredComputation:
        leaves, spec = trace_mod.flatten_args(args)
        # strides too: the capture bakes views that only some layouts allow
        key = (spec, tuple((tuple(x.shape), x.dtype, x.device, x.stride())
                           for x in leaves))
        comp = self._cache.get(key)
        if comp is None:
            comp = LoweredComputation(
                trace_mod.trace(self.fn, *args), backend=self.backend,
                spec=self.spec,
                resident_leaf_idx=self._resident_leaf_idx(args),
                resident_set=self.resident_set, policy=self.policy,
                device=self.device, mesh=self.mesh)
            self._cache[key] = comp
            while len(self._cache) > SIGNATURE_CACHE_CAPACITY:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(key)
        return comp

    def __call__(self, *args):
        return self.trace(*args).execute(*args)


def lower(fn, backend: Optional[str] = None,
          spec: Optional[ArraySpec] = None, mesh=None,
          resident_argnums: Tuple[int, ...] = (),
          resident_set=None, policy: Optional[str] = None,
          device=None) -> LoweredFunction:
    """Compile `fn` into a hybrid CiM/host callable (see module docstring).

    backend : CiM backend name for the fused regions (registry default
              when None).
    spec    : optional banked ArraySpec: region accesses tile over banks
              through the dispatch layer and the ledger charges per
              (device, bank) activations.
    mesh    : optional DeviceMesh forwarded to the tiling dispatcher: on a
              banked `spec`, each region access spreads its tiles over the
              mesh's "data" axis (`dispatch.execute_tiled`).
    resident_argnums : argument positions whose (pure) derivatives may be
              pinned in the resident region: region inputs derived solely
              from these arguments skip their per-call entry pack once
              pinned, and host ops that only feed pinned values are
              skipped on warm passes. Identity-fingerprinted: pass the
              SAME weight tensors each call to stay warm.
    resident_set : the ResidentSet to pin into (the process-wide registry
              set for `spec` when omitted, resolved per call).
    policy  : offload policy (repro_torch.cim.cost): "edp" (default, alias
              "cost") lowers an op only when its projected CiM EDP beats
              the near-memory baseline; "latency" compares against the
              DeviceSpec host roofline; "always" lowers every eligible op;
              "never" demotes all.
    device  : DeviceSpec for the host side of the comparison
              (cost.DEFAULT_DEVICE, an H100 SXM, when None).
    """
    return LoweredFunction(fn, backend=backend, spec=spec,
                           resident_argnums=resident_argnums,
                           resident_set=resident_set, policy=policy,
                           device=device, mesh=mesh)
