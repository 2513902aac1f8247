"""Spec-driven cost model: should this op run in the array at all?

Port of `repro.cim.cost` (pure Python over a `repro_torch.cim.trace.Trace`).
For every classified op it projects

  * a CiM cost: energy/latency/EDP in the paper's internal units, built
    from the same quantities the ledger charges (per-access activated
    words, `TilePlan` waves, streamed-load row writes, inter-bank reduction
    words), so projection and execution share one accounting;
  * a near-memory baseline cost: the paper's two-access read-modify-write
    on the same data, paying only the useful words;
  * a host roofline cost: time from a `DeviceSpec` (peak FLOP/s, device
    memory B/s, loadable from CSV) and a pJ/flop + pJ/byte energy model.

`plan_offload` turns the per-op verdicts into the lowering compiler's
offload decision (`repro_torch.cim.lower`).

Offload policies
----------------
  "always"  — lower every eligible op.
  "edp"     — the default ("cost" is an alias): lower an op only when its
              projected CiM EDP beats the near-memory baseline on the same
              operands. The `DeviceSpec` does not enter this decision, so
              the serve's regions do not depend on which row is the
              default. Unbanked placements always win under current
              sensing; this policy demotes pad-dominated banked placements
              and loss-making voltage schemes.
  "latency" — lower only when projected CiM wall time beats the host
              roofline time from the `DeviceSpec`.
  "never"   — demote everything (debugging / A-B measurement).

Region fusion re-evaluates at fusion boundaries: a losing op sandwiched
between winners may still fuse when hosting it would force the region to
unpack its packed operands and repack the host result (the pack/unpack
toll, one array read + one row write per crossing 32-bit word); the op
keeps `lowers=False` with `fused=True` so reports show the trade.
"""
from __future__ import annotations

import csv
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import energy

from . import accounting
from . import array as array_mod
from .array import ArraySpec

# ---------------------------------------------------------------------------
# DeviceSpec: the host side of the comparison
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Host-chip roofline constants (one row of a device CSV).

    The default row is one NVIDIA H100 SXM (NVIDIA's data sheet): dense
    bf16 tensor-core FLOP/s, HBM3 bytes/s, and one direction of one NVLink
    link as `ici_bw`. `pj_per_flop` / `pj_per_byte` are the reference's
    first-order energy-model parameters, not measurements of any card:
    they give the "edp" comparison a host energy to talk about.
    """

    name: str = "h100-sxm"
    peak_flops: float = 989e12     # dense bf16 FLOP/s per card
    hbm_bw: float = 3.35e12        # device memory bytes/s per card
    ici_bw: float = 450e9          # NVLink bytes/s, one direction
    pj_per_flop: float = 0.5       # host compute energy per scalar op
    pj_per_byte: float = 20.0      # host DRAM energy per byte moved

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "DeviceSpec":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown DeviceSpec fields {sorted(unknown)}")
        return cls(**{k: (v if k == "name" else float(v))
                      for k, v in d.items()})

    @classmethod
    def from_csv(cls, path: str, name: Optional[str] = None) -> "DeviceSpec":
        """Load a device row from a CSV with a header row naming the
        dataclass fields. With `name`, pick that row; otherwise the first."""
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
        if not rows:
            raise ValueError(f"no device rows in {path}")
        if name is None:
            return cls.from_dict(rows[0])
        for row in rows:
            if row.get("name") == name:
                return cls.from_dict(row)
        raise ValueError(f"device {name!r} not in {path} "
                         f"(have {[r.get('name') for r in rows]})")

    @property
    def key(self) -> Tuple:
        """Hashable identity for cache keys."""
        return tuple(dataclasses.astuple(self))


DEFAULT_DEVICE = DeviceSpec()

# ---------------------------------------------------------------------------
# offload policies
# ---------------------------------------------------------------------------

POLICIES = ("always", "edp", "latency", "never")
DEFAULT_POLICY = "edp"
_POLICY_ALIASES = {"cost": "edp"}


def normalize_policy(policy: Optional[str]) -> str:
    p = DEFAULT_POLICY if policy is None else _POLICY_ALIASES.get(policy,
                                                                  policy)
    if p not in POLICIES:
        raise ValueError(f"unknown offload policy {policy!r} "
                         f"(expected one of {POLICIES} or 'cost')")
    return p


# ---------------------------------------------------------------------------
# per-op accounting
# ---------------------------------------------------------------------------

#: streamed-operand entry packs per op kind (binary ops: 2, reductions: 1)
STREAM_LOADS = {"reduce_sum": 1, "population_count": 1}


def eqn_words32(op) -> float:
    """32-bit-word operations one execution of this op performs (mul and
    the contraction work at the 2n-bit product width on every access)."""
    if not op.eligible or op.accesses == 0:
        return 0.0
    bits = op.n_bits
    if op.kind == "single":
        return op.words * bits / 32.0
    if op.name in ("mul", "dot_general"):
        return op.accesses * op.words * (2 * bits) / 32.0
    return op.accesses * op.words * bits / 32.0    # reduce_sum / popcount


def eqn_stream_loads(op) -> int:
    """Fresh operand entry packs if nothing is memoized (upper bound:
    region fusion and residency remove loads, never add them)."""
    if not op.eligible or op.accesses == 0:
        return 0
    return STREAM_LOADS.get(op.name, 2)


def eqn_load_words32(op) -> float:
    """Row-write words driving those streamed packs into the array."""
    return eqn_stream_loads(op) * op.words * op.n_bits / 32.0


# ---------------------------------------------------------------------------
# per-op verdict
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EqnVerdict:
    """The cost model's projection and decision for ONE eligible op.

    Energy/latency fields are in the paper's internal units; `*_s` / `*_j`
    fields are physical. `margin` is the fractional win under `policy`
    (> 0: CiM wins; -0.25: CiM costs 25% more than the alternative)."""

    index: int                     # position in trace.ops
    name: str
    kind: str
    n_bits: int
    words: int
    accesses: int
    banked_accesses: int           # accesses * n_tiles (== ledger, banked)
    waves: int                     # accesses * plan.waves (critical path)
    words32: float                 # useful 32-bit-word ops
    activated_words32: float       # incl. pad columns of partial tiles
    load_words32: float            # streamed entry-pack row writes
    inter_bank_words32: float      # cross-tile reduction traffic
    cim_energy: float              # internal units, as bank_report charges
    cim_latency: float
    base_energy: float             # near-memory two-access baseline
    base_latency: float
    host_time_s: float             # DeviceSpec roofline
    host_energy_j: float
    policy: str
    lowers: bool                   # the decision under `policy`
    fused: bool = False            # losing op kept fused (sandwich toll)
    margin: float = 0.0
    reason: str = ""

    @property
    def cim_edp(self) -> float:
        return self.cim_energy * self.cim_latency

    @property
    def base_edp(self) -> float:
        return self.base_energy * self.base_latency

    @property
    def cim_time_s(self) -> float:
        return self.cim_latency * energy.T0_NS * 1e-9

    @property
    def cim_energy_j(self) -> float:
        return self.cim_energy * energy.E0_FJ * 1e-15

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["cim_edp"] = self.cim_edp
        d["base_edp"] = self.base_edp
        return d


def ecc_overhead(n_bits: int) -> float:
    """Fractional row/load overhead of SECDED on an n_bits resident pack:
    parity planes per data plane (5/8 at int8, see planepack)."""
    from .planepack import ecc_plane_count

    return ecc_plane_count(n_bits) / max(1, n_bits)


def project_eqn(op, index: int, spec: Optional[ArraySpec], res,
                device: DeviceSpec, policy: str,
                ecc_overhead_ratio: float = 0.0) -> EqnVerdict:
    """Project one eligible op's CiM / baseline / host costs and decide
    whether it lowers under `policy`. `res` is an `energy.SchemeResult`.
    `ecc_overhead_ratio` (> 0 when resident operands run ECC-protected)
    scales the streamed-load row writes."""
    from .trace import aval_of, host_flops, host_io_bits

    words32 = eqn_words32(op)
    load_w32 = eqn_load_words32(op) * (1.0 + max(0.0, ecc_overhead_ratio))

    if spec is not None and op.words >= 1 and op.accesses > 0:
        plan = spec.plan(op.words)
        n_tiles = plan.n_tiles
        waves = op.accesses * plan.waves
        banked_accesses = op.accesses * n_tiles
        # activated words include the idle pad columns of partial tiles:
        # exactly the ratio charge_banked bills over the useful words
        activated = words32 * (n_tiles * plan.tile_words / max(1, op.words))
    else:
        n_tiles = 1
        waves = op.accesses
        banked_accesses = op.accesses
        activated = words32

    inter32 = 0.0
    if n_tiles > 1 and op.name in ("reduce_sum", "dot_general"):
        out_words = 1
        for d in aval_of(op.outvars[0]).shape:
            out_words *= int(d)
        inter32 = (n_tiles - 1) * out_words * max(op.n_bits, 32) / 32.0

    # -- CiM side: the ledger's bank_report formulas per op -----------------
    e_cim = (res.cim.energy * activated
             + res.read.energy * load_w32
             + accounting.E_HOP_WORD32 * inter32)
    slots = spec.banks if spec is not None else 1
    t_cim = (res.cim.latency * max(1, waves)
             + accounting.T_HOP_WORD32 * inter32 / max(1, slots))

    # -- near-memory baseline: bank_report's wave structure, useful words --
    e_base = res.baseline.energy * words32
    t_base = res.baseline.latency * max(1, waves)

    # -- host roofline from the DeviceSpec ---------------------------------
    flops = host_flops(op)
    host_bytes = -(-host_io_bits(op) // 8)
    host_time = max(flops / device.peak_flops, host_bytes / device.hbm_bw)
    host_energy = (flops * device.pj_per_flop
                   + host_bytes * device.pj_per_byte) * 1e-12

    cim_time_s = t_cim * energy.T0_NS * 1e-9
    if op.accesses == 0:
        lowers, margin, reason = True, 0.0, "free"
    elif policy == "always":
        lowers, margin, reason = True, 0.0, "forced"
    elif policy == "never":
        lowers, margin, reason = False, 0.0, "forced"
    elif policy == "latency":
        lowers = cim_time_s <= host_time
        margin = 1.0 - cim_time_s / host_time if host_time > 0 else -1.0
        reason = "cim faster than host roofline" if lowers \
            else "host roofline faster"
    else:                                   # "edp"
        cim_edp = e_cim * t_cim
        base_edp = e_base * t_base
        lowers = cim_edp <= base_edp
        margin = 1.0 - cim_edp / base_edp if base_edp > 0 else 0.0
        reason = "cim edp beats near-memory baseline" if lowers \
            else "pad/load overhead loses to baseline"

    return EqnVerdict(
        index=index, name=op.name, kind=op.kind, n_bits=op.n_bits,
        words=op.words, accesses=op.accesses,
        banked_accesses=banked_accesses, waves=waves,
        words32=words32, activated_words32=activated,
        load_words32=load_w32, inter_bank_words32=inter32,
        cim_energy=e_cim, cim_latency=t_cim,
        base_energy=e_base, base_latency=t_base,
        host_time_s=host_time, host_energy_j=host_energy,
        policy=policy, lowers=lowers, margin=margin, reason=reason)


# ---------------------------------------------------------------------------
# the offload plan: verdicts + demotions
# ---------------------------------------------------------------------------

#: process-wide decision counters (serve report / diagnostics)
PLAN_STATS = {"plans": 0, "eqns_lowered": 0, "eqns_demoted": 0,
              "demoted_accesses": 0, "fused_despite_loss": 0}


def reset_plan_stats() -> None:
    for k in PLAN_STATS:
        PLAN_STATS[k] = 0


@dataclasses.dataclass(frozen=True)
class OffloadPlan:
    """plan_offload's output: one verdict per eligible op plus the set of
    op indices demoted to host execution."""

    policy: str
    scheme: str
    rows: int
    device: DeviceSpec
    verdicts: Tuple[EqnVerdict, ...]
    demoted: frozenset

    def verdict_for(self, index: int) -> Optional[EqnVerdict]:
        for v in self.verdicts:
            if v.index == index:
                return v
        return None

    @property
    def demoted_eqns(self) -> int:
        return len(self.demoted)

    @property
    def demoted_accesses(self) -> int:
        return sum(v.accesses for v in self.verdicts
                   if v.index in self.demoted)

    @property
    def fused_losses(self) -> int:
        return sum(1 for v in self.verdicts if v.fused)


def _crossing_words32(tr, seg: Sequence[int], pos: int) -> float:
    """Packed words that would cross a host detour at seg[pos]: values
    produced by ops before the split and consumed by ops after it (within
    the fused run); each pays one array read out and one row write back
    if the sandwiched op is hosted."""
    from .trace import aval_of, dtype_bits

    produced = set()
    for i in seg[:pos]:
        produced.update(id(v) for v in tr.ops[i].outvars)
    crossing = {}
    for j in seg[pos + 1:]:
        for v in tr.ops[j].invars:
            if id(v) in produced and id(v) not in crossing:
                crossing[id(v)] = v
    w32 = 0.0
    for v in crossing.values():
        aval = aval_of(v)
        nel = 1
        for d in aval.shape:
            nel *= int(d)
        w32 += nel * dtype_bits(aval.dtype) / 32.0
    return w32


def _keeps_fused(tr, seg: Sequence[int], pos: int, v: EqnVerdict, res,
                 device: DeviceSpec, policy: str) -> bool:
    """Is fusing this losing op cheaper than the host detour it avoids?
    The detour pays the pack/unpack toll: every crossing word32 is read
    out of the array and written back (2 x standard-read energy), and the
    region serializes behind 2 extra array passes."""
    toll_w32 = _crossing_words32(tr, seg, pos)
    if toll_w32 <= 0:
        return False
    if policy == "latency":
        toll_s = 2.0 * toll_w32 * 4.0 / device.hbm_bw
        return v.cim_time_s <= v.host_time_s + toll_s
    detour_e = v.base_energy + 2.0 * res.read.energy * toll_w32
    detour_t = v.base_latency + 2.0 * res.read.latency
    return v.cim_edp <= detour_e * detour_t


def plan_offload(tr, spec: Optional[ArraySpec] = None,
                 scheme: str = "current", rows: int = 1024,
                 device: Optional[DeviceSpec] = None,
                 policy: Optional[str] = None) -> OffloadPlan:
    """Decide, per eligible op of `tr`, whether it lowers to the array.

    Demotion works on maximal runs of consecutive eligible ops (the
    regions the lowering compiler would fuse): losing ops at a run's edges
    are demoted outright; an interior loser is kept fused when the
    pack/unpack toll of hosting it exceeds its loss (`fused=True` on its
    verdict), else the run splits around it and the halves re-evaluate.
    While registry pins are ECC-protected (`array.set_resident_ecc`) every
    streamed load also pays its parity planes (`ecc_overhead`)."""
    policy = normalize_policy(policy)
    device = device or DEFAULT_DEVICE
    res = accounting._SCHEMES[scheme](rows)

    verdicts: Dict[int, EqnVerdict] = {}
    for i, op in enumerate(tr.ops):
        if op.eligible:
            # free ops the aten capture adds (view/reshape, where) carry
            # n_bits 0 and load nothing, so they pay no parity either
            ratio = ecc_overhead(op.n_bits) \
                if array_mod.resident_ecc_default() and op.n_bits else 0.0
            verdicts[i] = project_eqn(op, i, spec, res, device, policy,
                                      ecc_overhead_ratio=ratio)

    demoted: set = set()
    if policy == "never":
        demoted = set(verdicts)
    elif policy != "always":
        runs: List[List[int]] = []
        for i, op in enumerate(tr.ops):
            if not op.eligible:
                continue
            if runs and runs[-1][-1] == i - 1:
                runs[-1].append(i)
            else:
                runs.append([i])

        def wins(i: int) -> bool:
            return verdicts[i].lowers

        fused: set = set()
        stack = list(runs)
        while stack:
            seg = stack.pop()
            while seg and not wins(seg[0]):
                demoted.add(seg.pop(0))
            while seg and not wins(seg[-1]):
                demoted.add(seg.pop())
            split_at = None
            for pos in range(1, len(seg) - 1):
                i = seg[pos]
                if wins(i):
                    continue
                if _keeps_fused(tr, seg, pos, verdicts[i], res, device,
                                policy):
                    continue
                split_at = pos
                break
            if split_at is None:
                fused.update(i for i in seg[1:-1] if not wins(i))
                continue
            demoted.add(seg[split_at])
            stack.append(seg[:split_at])
            stack.append(seg[split_at + 1:])
        for i in fused:
            verdicts[i] = dataclasses.replace(verdicts[i], fused=True)

    plan = OffloadPlan(policy=policy, scheme=scheme, rows=rows,
                       device=device,
                       verdicts=tuple(verdicts[i] for i in sorted(verdicts)),
                       demoted=frozenset(demoted))
    PLAN_STATS["plans"] += 1
    PLAN_STATS["eqns_lowered"] += len(plan.verdicts) - len(plan.demoted)
    PLAN_STATS["eqns_demoted"] += len(plan.demoted)
    PLAN_STATS["demoted_accesses"] += plan.demoted_accesses
    PLAN_STATS["fused_despite_loss"] += plan.fused_losses
    return plan


# ---------------------------------------------------------------------------
# "when does CiM win?" — representative shapes for docs/diagnostics
# ---------------------------------------------------------------------------


def cim_wins_rows(device: Optional[DeviceSpec] = None,
                  scheme: str = "current", rows: int = 1024) -> List[Dict]:
    """Three representative shapes through the cost model: an unbanked
    elementwise op (wins), a banked well-utilized matmul tile (wins), and a
    pad-dominated banked sliver (loses)."""
    import torch

    from .trace import int_contract, trace

    device = device or DEFAULT_DEVICE
    cases = [
        ("int16 add, 4096 words, unbanked",
         lambda a, b: a + b,
         (torch.zeros(4096, dtype=torch.int16),
          torch.ones(4096, dtype=torch.int16)),
         None),
        ("int8 matmul 16x64 @ 64x64, banked 4x(4x256)",
         int_contract,
         (torch.ones((16, 64), dtype=torch.int8),
          torch.ones((64, 64), dtype=torch.int8)),
         ArraySpec(banks=4, subarrays=4, rows=rows, bitline_words=256)),
        ("int16 add, 4 words on 32-word tiles (12% utilized)",
         lambda a, b: a + b,
         (torch.zeros(4, dtype=torch.int16), torch.ones(4, dtype=torch.int16)),
         ArraySpec(banks=2, subarrays=1, rows=rows, bitline_words=32)),
    ]
    out = []
    for label, fn, args, spec in cases:
        plan = plan_offload(trace(fn, *args), spec=spec, scheme=scheme,
                            rows=rows, device=device, policy="edp")
        v = max(plan.verdicts, key=lambda x: x.accesses)
        out.append({
            "shape": label,
            "cim_edp": v.cim_edp,
            "baseline_edp": v.base_edp,
            "edp_margin_pct": 100.0 * v.margin,
            "host_time_ns": v.host_time_s * 1e9,
            "cim_time_ns": v.cim_time_s * 1e9,
            "lowers": v.lowers,
        })
    return out


def cim_wins_table(device: Optional[DeviceSpec] = None,
                   scheme: str = "current", rows: int = 1024) -> str:
    """`cim_wins_rows` rendered as a markdown table."""
    lines = ["| shape | CiM EDP | baseline EDP | EDP margin | verdict |",
             "|---|---:|---:|---:|---|"]
    for r in cim_wins_rows(device, scheme, rows):
        lines.append(
            f"| {r['shape']} | {r['cim_edp']:.1f} | {r['baseline_edp']:.1f} "
            f"| {r['edp_margin_pct']:+.1f}% | "
            f"{'lower' if r['lowers'] else 'host'} |")
    return "\n".join(lines)


if __name__ == "__main__":          # pragma: no cover
    print(cim_wins_table())
