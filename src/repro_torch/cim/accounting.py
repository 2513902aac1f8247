"""Per-op energy accounting for the CiM engine, wired through
repro_torch.core.energy.

Port of `repro.cim.accounting` (pure Python, no tensors): every engine
execution charges a ledger with the ADRA memory accesses and 32-bit-word
operations it represents, and the ledger projects array-level
energy/latency/EDP through the calibrated paper model. The fused engine
charges ONE access per op-set; streamed operands charge their row-write
loads, resident operands a zero-load reuse. On a banked array
`charge_banked` attributes one activation per tile to its (device, bank)
slot and counts the last tile's idle columns as activated words,
`charge_reduction` counts the words a cross-tile reduction step moves
between banks, and `bank_report` turns both into a contention-adjusted EDP
projection. Schedules executed through
`repro_torch.cim.macro.run_schedule_program` record their charges once, as a
`PlannedCharges` object, and replay it on every invocation. `charge_ecc`
bills the parity planes of ECC-protected resident operands and
`charge_fault` the outcome bits of a fault campaign (`repro_torch.cim.faults`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core import energy

#: modeled interconnect cost of moving one 32-bit word between banks during
#: a cross-tile reduction step (fractions of one standard 1024-row read)
E_HOP_WORD32 = 0.05
T_HOP_WORD32 = 0.01


@dataclasses.dataclass
class Ledger:
    """Counts of ADRA accesses executed through the engine.

    bank_accesses      : activations per (device, bank) slot; the unbanked
                         engine path charges slot (0, 0).
    activated_words32  : 32-bit-word slots ACTIVATED (incl. the idle columns
                         of partially-filled tiles) — >= words32.
    inter_bank_words32 : words crossing banks in reduction steps.
    load_accesses      : operand-load (row-write) accesses: a STREAMED
                         operand must be driven into the array rows before
                         an access can compute over it — one load per
                         operand entry pack (per tile when placed). Resident
                         operands skip this charge; that skip is the paper's
                         stored-operand assumption made measurable.
    load_words32       : word-equivalents written by operand loads.
    resident_reuses    : resident-operand reuses (entry pack skipped).
    resident_words32   : word-equivalents those reuses did NOT re-write.
    ecc_accesses       : parity-plane accesses (extra row writes at pin
                         time, parity reads per verify/scrub) — the
                         protection overhead, kept out of total_accesses so
                         compute/load bills are comparable with ECC off.
    ecc_words32        : word-equivalents those parity planes moved.
    fault_injected     : bits flipped into live data by the fault overlay.
    fault_detected     : bits an ECC verify saw (corrected + uncorrected).
    fault_corrected    : bits SECDED repaired in place.
    fault_uncorrected  : bits detected but NOT repairable — the entry was
                         invalidated and rebuilt; a nonzero steady-state
                         value is data loss and is gated never-grow in CI.
    """

    accesses: int = 0
    words32: float = 0.0          # 32-bit-word-equivalent ops charged
    per_op: Dict[str, int] = dataclasses.field(default_factory=dict)
    bank_accesses: Dict[Tuple[int, int], int] = dataclasses.field(
        default_factory=dict)
    activated_words32: float = 0.0
    inter_bank_words32: float = 0.0
    load_accesses: int = 0
    load_words32: float = 0.0
    resident_reuses: int = 0
    resident_words32: float = 0.0
    ecc_accesses: int = 0
    ecc_words32: float = 0.0
    fault_injected: int = 0
    fault_detected: int = 0
    fault_corrected: int = 0
    fault_uncorrected: int = 0
    enabled: bool = True

    @property
    def total_accesses(self) -> int:
        """Compute accesses + streamed operand-load accesses — the number a
        resident-operand execution strictly shrinks vs the repack path
        (compute accesses alone are identical by construction)."""
        return self.accesses + self.load_accesses

    def charge(self, ops: Tuple[str, ...], n_bits: int, n_words: int,
               accesses: int = 1) -> None:
        if not self.enabled:
            return
        self.accesses += accesses
        self.words32 += n_words * n_bits / 32.0 * accesses
        self.activated_words32 += n_words * n_bits / 32.0 * accesses
        self.bank_accesses[(0, 0)] = \
            self.bank_accesses.get((0, 0), 0) + accesses
        for op in ops:
            self.per_op[op] = self.per_op.get(op, 0) + 1

    def charge_banked(self, ops: Tuple[str, ...], n_bits: int, n_words: int,
                      plan, n_devices: int = 1) -> None:
        """One logical op executed as `plan.n_tiles` bank activations: the
        word-work is charged once, the activations land on their (device,
        bank) slots and the last tile's idle columns count as activated."""
        if not self.enabled:
            return
        self.accesses += plan.n_tiles
        self.words32 += n_words * n_bits / 32.0
        self.activated_words32 += \
            plan.n_tiles * plan.tile_words * n_bits / 32.0
        for slot, n in plan.bank_counts(n_devices).items():
            self.bank_accesses[slot] = self.bank_accesses.get(slot, 0) + n
        for op in ops:
            self.per_op[op] = self.per_op.get(op, 0) + 1

    def charge_reduction(self, words32: float) -> None:
        """Inter-bank traffic of a cross-tile reduction step."""
        if not self.enabled:
            return
        self.inter_bank_words32 += words32

    def charge_load(self, n_bits: int, n_words: int,
                    n_tiles: int = 1) -> None:
        """Row-writes driving one STREAMED operand entry pack into the
        array — one load access per tile it lands on. Pins charge this
        exactly once; streamed operands pay it every call."""
        if not self.enabled:
            return
        self.load_accesses += n_tiles
        self.load_words32 += n_words * n_bits / 32.0

    def charge_resident_reuse(self, n_bits: int, n_words: int) -> None:
        """One resident-operand reuse: the entry pack (and its load
        accesses) was skipped because the operand already lives in rows."""
        if not self.enabled:
            return
        self.resident_reuses += 1
        self.resident_words32 += n_words * n_bits / 32.0

    def charge_ecc(self, n_parity_bits: int, n_words: int,
                   n_tiles: int = 1) -> None:
        """Parity-plane traffic of ECC protection: the extra rows written
        at pin time and the parity reads of each verify or scrub pass."""
        if not self.enabled:
            return
        self.ecc_accesses += n_tiles
        self.ecc_words32 += n_words * n_parity_bits / 32.0

    def charge_fault(self, injected: int = 0, detected: int = 0,
                     corrected: int = 0, uncorrected: int = 0) -> None:
        """Fault-campaign outcome bits (see repro_torch.cim.faults)."""
        if not self.enabled:
            return
        self.fault_injected += injected
        self.fault_detected += detected
        self.fault_corrected += corrected
        self.fault_uncorrected += uncorrected

    def reset(self) -> None:
        """Restore every counter to its dataclass default.

        Introspective on purpose: a hand-written field list silently stops
        clearing newly added counters the day someone forgets to extend it.
        """
        for f in dataclasses.fields(self):
            if f.name == "enabled":
                continue
            if f.default is not dataclasses.MISSING:
                setattr(self, f.name, f.default)
            else:
                setattr(self, f.name, f.default_factory())

    def per_device(self) -> Dict[int, int]:
        """Activations per device (sum of that device's bank slots)."""
        out: Dict[int, int] = {}
        for (dev, _bank), n in self.bank_accesses.items():
            out[dev] = out.get(dev, 0) + n
        return out

    def projected(self, scheme: str = "current", rows: int = 1024) -> Dict[str, float]:
        """Array-level projection of the charged work through the paper model."""
        return project_savings(self.words32, scheme=scheme, rows=rows)

    def bank_report(self, spec, scheme: str = "current",
                    rows: int = 1024) -> Dict[str, float]:
        """Contention-adjusted EDP projection of the charged bank traffic.

        Energy follows ACTIVATED words (idle columns of a partial tile burn
        bitline energy too) plus E_HOP_WORD32 per inter-bank word; latency
        follows the busiest slot's wave count (banks run concurrently,
        waves serialize) plus the hops spread over the slots. The baseline
        is the same word-work through the two-access near-memory path."""
        res = _SCHEMES[scheme](rows)
        total = sum(self.bank_accesses.values()) or 1
        waves = max(self.bank_accesses.values(), default=1)
        devices = 1 + max((d for d, _ in self.bank_accesses), default=0)
        slots = spec.banks * devices
        ideal_waves = -(-total // slots)

        e_cim = res.cim.energy * self.activated_words32 \
            + E_HOP_WORD32 * self.inter_bank_words32
        t_cim = res.cim.latency * waves \
            + T_HOP_WORD32 * self.inter_bank_words32 / max(1, slots)
        e_base = res.baseline.energy * self.activated_words32
        t_base = res.baseline.latency * waves
        base_edp = e_base * t_base
        return {
            "banks": float(spec.banks),
            "devices": float(devices),
            "activations": float(total),
            "waves": float(waves),
            "ideal_waves": float(ideal_waves),
            "contention_factor": waves / max(1, ideal_waves),
            "utilization": self.words32 / max(1e-12, self.activated_words32),
            "words_per_access": self.activated_words32 / total,
            "inter_bank_words32": self.inter_bank_words32,
            "cim_energy": e_cim,
            "cim_latency": t_cim,
            "cim_edp": e_cim * t_cim,
            "baseline_edp": base_edp,
            # 0.0 on an empty ledger (no charged work, no saving)
            "edp_decrease_pct": (100.0 * (1.0 - (e_cim * t_cim) / base_edp)
                                 if base_edp else 0.0),
        }


#: process-wide ledger the engine charges into
LEDGER = Ledger()


@dataclasses.dataclass(frozen=True)
class PlannedCharges:
    """The ledger record of ONE schedule execution, computed from the plan.

    While a schedule program first runs, each planned access appends one
    entry — ("access", ops, n_bits, n_words) for the unbanked engine,
    ("banked", ops, n_bits, n_words, plan, n_devices) for the tiling
    dispatcher, ("reduction", words32) for inter-bank reduction traffic,
    ("load", n_bits, n_words, n_tiles) for a streamed operand's row-writes,
    ("resident", n_bits, n_words) for a resident-operand reuse — and
    `replay()` applies the whole record to the ledger on every invocation. Because the
    ScheduleCursor refuses any access its plan does not contain, the record
    matches both the plan and the execution: accesses == schedule.accesses.
    """

    entries: Tuple[Tuple, ...]

    @property
    def accesses(self) -> int:
        """Array accesses one replay charges (logical, not per-tile)."""
        return sum(1 for e in self.entries if e[0] in ("access", "banked"))

    def replay(self, ledger: Optional["Ledger"] = None) -> None:
        led = LEDGER if ledger is None else ledger
        for entry in self.entries:
            kind = entry[0]
            if kind == "access":
                _, ops, n_bits, n_words = entry
                led.charge(ops, n_bits, n_words)
            elif kind == "banked":
                _, ops, n_bits, n_words, plan, n_devices = entry
                led.charge_banked(ops, n_bits, n_words, plan,
                                  n_devices=n_devices)
            elif kind == "reduction":
                led.charge_reduction(entry[1])
            elif kind == "load":
                _, n_bits, n_words, n_tiles = entry
                led.charge_load(n_bits, n_words, n_tiles=n_tiles)
            elif kind == "resident":
                _, n_bits, n_words = entry
                led.charge_resident_reuse(n_bits, n_words)
            else:                              # pragma: no cover
                raise ValueError(f"unknown charge entry {kind!r}")


def ledger() -> Ledger:
    return LEDGER


_SCHEMES = {
    "current": energy.current_sensing,
    "scheme1": energy.voltage_scheme1,
    "scheme2": energy.voltage_scheme2,
}


def project_savings(words32: float, scheme: str = "current",
                    rows: int = 1024) -> Dict[str, float]:
    """Energy/latency/EDP of `words32` word-ops: ADRA CiM vs the two-access
    near-memory baseline, in both internal units and physical estimates."""
    res = _SCHEMES[scheme](rows)
    return {
        "words32": words32,
        "cim_energy": res.cim.energy * words32,
        "baseline_energy": res.baseline.energy * words32,
        "energy_saved": (res.baseline.energy - res.cim.energy) * words32,
        "energy_saved_fj": energy.to_fj(
            (res.baseline.energy - res.cim.energy) * words32),
        "speedup": res.speedup,
        "edp_decrease_pct": res.edp_decrease_pct,
    }
