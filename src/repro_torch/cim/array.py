"""Banked CiM array substrate: physical geometry, tile placement, residency.

Port of `repro.cim.array`. An `ArraySpec` describes the physical array — banks
of subarrays of rows x bitline words, with whole banks optionally taken out
of service — and its `plan()` turns an operand word count into a
`TilePlan`: which words go to which bank activation, round-robin over the
live banks. The tiling dispatcher (`repro_torch.cim.dispatch`) executes
that plan and the ledger charges it per (device, bank).

A `ResidentSet` tracks plane stacks pinned in bank rows across calls (the
paper's stored-operand assumption): every pin charges the ledger its
operand-load accesses once, every reuse charges none, pins are LRU-evicted
under row pressure, and `reserve()` row claims (paged KV blocks) are never
evicted. Rows the registry set of a geometry holds shrink what
`check_fits` allows a streamed access there. With ECC (`ResidentSet(ecc=)`,
or `set_resident_ecc` for the registry sets) every pin carries SECDED
parity rows, verified on every `get` and by `scrub`. Counters aggregate
process-wide into `dispatch.cache_stats()`.

`set_current_spec` installs a process-wide spec (the failover lever): call
sites whose `spec=None` means "the current geometry" resolve through
`current_spec()`, and the layers whose `spec=None` means unbanked consult
`spec_override()`.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence, Tuple

from . import opset


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """Physical geometry of a banked ADRA CiM array.

    banks          : independently activatable banks (concurrent).
    subarrays      : subarrays per bank, activated together per access.
    rows           : wordlines per subarray — bounds the plane budget of one
                     access (two operand stacks + every requested output).
    bitline_words  : words served per subarray activation; a multiple of 32
                     so tiles align with the packed lanes of PlanePack.
    disabled_banks : banks taken out of service. Placement round-robins over
                     the enabled banks only; the default () keeps a healthy
                     spec equal (and equally hashed) to one built without
                     it, so every spec-keyed cache separates the two.
    """

    banks: int = 4
    subarrays: int = 4
    rows: int = 1024
    bitline_words: int = 1024
    disabled_banks: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.banks < 1 or self.subarrays < 1 or self.rows < 1:
            raise opset.CimOpError(f"degenerate ArraySpec: {self}")
        if self.bitline_words < 32 or self.bitline_words % 32:
            raise opset.CimOpError(
                f"bitline_words must be a positive multiple of 32 (packed "
                f"lanes), got {self.bitline_words}")
        dead = tuple(sorted(set(int(b) for b in self.disabled_banks)))
        if any(b < 0 or b >= self.banks for b in dead):
            raise opset.CimOpError(
                f"disabled_banks {dead} outside [0, {self.banks})")
        if len(dead) >= self.banks:
            raise opset.CimOpError(
                f"every bank of {self} disabled: nothing left to remap to")
        object.__setattr__(self, "disabled_banks", dead)

    @property
    def enabled_banks(self) -> Tuple[int, ...]:
        """Live bank ids, in order — what placement round-robins over."""
        dead = set(self.disabled_banks)
        return tuple(b for b in range(self.banks) if b not in dead)

    @property
    def n_enabled(self) -> int:
        return self.banks - len(self.disabled_banks)

    def disable_bank(self, bank: int) -> "ArraySpec":
        """The degraded spec with `bank` also dead (raises when that would
        leave no live bank)."""
        return dataclasses.replace(
            self, disabled_banks=self.disabled_banks + (int(bank),))

    @property
    def tile_words(self) -> int:
        """Words one bank activation serves = the tiling granule."""
        return self.subarrays * self.bitline_words

    @property
    def parallel_words(self) -> int:
        """Words the whole array serves per wave (every live bank active)."""
        return self.n_enabled * self.tile_words

    def check_fits(self, n_bits: int, ops: Sequence[str],
                   resident_rows: int = 0) -> None:
        """One access must fit its planes in the rows of a subarray: 2
        operand stacks of n_bits plus every requested output, beside the
        rows the resident region holds there."""
        need = 2 * n_bits + sum(opset.out_rows(op, n_bits) for op in ops)
        if need + resident_rows > self.rows:
            occupancy = (f" with {resident_rows} rows held by resident "
                         f"operands" if resident_rows else "")
            raise opset.CimOpError(
                f"access needs {need} rows (2x{n_bits} operand planes + "
                f"outputs {tuple(ops)}){occupancy} but subarrays have "
                f"{self.rows}")

    def plan(self, n_words: int) -> "TilePlan":
        if n_words < 1:
            raise opset.CimOpError(f"cannot place {n_words} words")
        n_tiles = -(-n_words // self.tile_words)
        return TilePlan(n_words=n_words, tile_words=self.tile_words,
                        n_tiles=n_tiles, banks=self.banks,
                        enabled=(self.enabled_banks
                                 if self.disabled_banks else ()))


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Placement of an operand pair onto a banked array: tile t covers words
    [t * tile_words, (t+1) * tile_words) and runs on the t-th live bank in
    round-robin order during wave t // n_live. `enabled` names the live
    banks of a degraded array; the default () means all `banks` are live,
    so healthy plans compare and hash as they did before banks could fail."""

    n_words: int
    tile_words: int
    n_tiles: int
    banks: int
    enabled: Tuple[int, ...] = ()

    @property
    def live_banks(self) -> Tuple[int, ...]:
        return self.enabled if self.enabled else tuple(range(self.banks))

    @property
    def n_live(self) -> int:
        return len(self.enabled) if self.enabled else self.banks

    @property
    def lanes_per_tile(self) -> int:
        return self.tile_words // 32

    @property
    def waves(self) -> int:
        """Sequential activations on the busiest bank (the critical path)."""
        return -(-self.n_tiles // self.n_live)

    @property
    def pad_words(self) -> int:
        """Idle bitline columns of the last tile (activated, operand-less)."""
        return self.n_tiles * self.tile_words - self.n_words

    def bank_of(self, tile: int) -> int:
        """Physical bank of tile `tile` — never a disabled bank."""
        live = self.live_banks
        return live[tile % len(live)]

    def bank_counts(self, n_devices: int = 1) -> Dict[Tuple[int, int], int]:
        """Activations per (device, bank), closed form: device d owns a
        contiguous tile block and live bank slot s every tile == s mod
        n_live in it. Keys are physical bank ids; dead banks never appear."""
        live = self.live_banks
        n_live = len(live)

        def upto(x: int, s: int) -> int:
            return (x - s + n_live - 1) // n_live

        per_dev = -(-self.n_tiles // n_devices)
        counts: Dict[Tuple[int, int], int] = {}
        for d in range(n_devices):
            lo = min(d * per_dev, self.n_tiles)
            hi = min(lo + per_dev, self.n_tiles)
            for s, b in enumerate(live):
                n = upto(hi, s) - upto(lo, s)
                if n:
                    counts[(d, b)] = n
        return counts


#: the paper's array, four banks of four subarrays
DEFAULT_SPEC = ArraySpec()


@dataclasses.dataclass
class ResidentEntry:
    """One pinned occupant of the resident region (pack None for a
    `reserve()` row claim). `fingerprint` names the source tensors: a
    mismatched `get()` drops the entry as stale. `ecc_parity` holds the
    SECDED parity planes when the set runs with ECC (their rows are in
    `rows_by_bank`), `scrubbed_s` the fault-model clock of the last verify,
    over which retention decay is integrated."""

    key: Tuple
    pack: Any
    rows_by_bank: Dict[int, int]
    words32: float = 0.0
    fingerprint: Tuple = ()
    evictable: bool = True
    aux: Any = None
    hits: int = 0
    ecc_parity: Any = None
    scrubbed_s: float = 0.0


class ResidentSet:
    """Row-budget-checked resident region of one banked array. With `ecc`
    every pin carries SECDED parity planes (`planepack.ecc_encode`) in
    extra rows of the same banks, and every `get` verifies and repairs it
    (after the active fault model's resident flips) on the planes' own
    device; `scrub` does the same for every pin, with retention decay."""

    def __init__(self, spec: Optional[ArraySpec] = None,
                 reserve_rows: int = 0, ecc: bool = False):
        self.spec = spec or DEFAULT_SPEC
        if reserve_rows < 0 or reserve_rows >= self.spec.rows:
            raise opset.CimOpError(
                f"reserve_rows must be in [0, {self.spec.rows}), "
                f"got {reserve_rows}")
        self.reserve_rows = reserve_rows
        self.ecc = bool(ecc)
        self._entries: "OrderedDict[Tuple, ResidentEntry]" = OrderedDict()
        self.pins = 0
        self.reserves = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.ecc_corrected = 0
        self.ecc_uncorrected = 0
        self.ecc_verifies = 0
        _ALL_SETS.add(self)

    # -- occupancy ----------------------------------------------------------
    def rows_per_bank(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for e in self._entries.values():
            for b, r in e.rows_by_bank.items():
                out[b] = out.get(b, 0) + r
        return out

    @property
    def resident_rows(self) -> int:
        """Rows held in the busiest bank."""
        return max(self.rows_per_bank().values(), default=0)

    @property
    def budget(self) -> int:
        return self.spec.rows - self.reserve_rows

    def _rows_for(self, n_bits: int, n_words: int) -> Dict[int, int]:
        """Per-bank rows of an n_bits pack of n_words (same-bank tiles stack)."""
        plan = self.spec.plan(n_words)
        return {b: n_bits * n for (_d, b), n in plan.bank_counts(1).items()}

    def fits(self, rows_by_bank: Dict[int, int]) -> bool:
        occ = self.rows_per_bank()
        return all(occ.get(b, 0) + r <= self.budget
                   for b, r in rows_by_bank.items())

    # -- lifecycle ----------------------------------------------------------
    def peek(self, key: Tuple,
             fingerprint: Optional[Tuple] = None) -> bool:
        """Presence and fingerprint test without counters or LRU movement."""
        entry = self._entries.get(key)
        return entry is not None and (
            fingerprint is None or entry.fingerprint == tuple(fingerprint))

    def get(self, key: Tuple,
            fingerprint: Optional[Tuple] = None) -> Optional[ResidentEntry]:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            _STATS["resident_misses"] += 1
            return None
        if fingerprint is not None and entry.fingerprint != tuple(fingerprint):
            del self._entries[key]
            self.invalidations += 1
            _STATS["resident_invalidations"] += 1
            self.misses += 1
            _STATS["resident_misses"] += 1
            return None
        if entry.ecc_parity is not None and not self._verify(entry):
            # uncorrectable: the entry was dropped, the caller rebuilds it
            self.misses += 1
            _STATS["resident_misses"] += 1
            return None
        entry.hits += 1
        self.hits += 1
        _STATS["resident_hits"] += 1
        self._entries.move_to_end(key)
        return entry

    def pin(self, key: Tuple, pack, fingerprint: Tuple = (),
            aux: Any = None) -> ResidentEntry:
        """Write `pack` into resident rows (evicting LRU pins to fit) and
        charge the one-time operand load the pin replaces per call. With
        `ecc` the parity planes are encoded here, stored as extra rows of
        the same banks and their row writes charged (`charge_ecc`)."""
        from . import faults as faults_mod
        from .accounting import LEDGER
        from .planepack import ecc_encode, ecc_plane_count

        if key in self._entries:
            del self._entries[key]
        parity = None
        n_ecc = 0
        if self.ecc:
            parity = ecc_encode(pack.planes)
            n_ecc = ecc_plane_count(pack.n_bits)
        rows = self._rows_for(pack.n_bits + n_ecc, pack.n_words)
        self._make_room(key, rows)
        fm = faults_mod.active() if self.ecc else None
        entry = ResidentEntry(key=key, pack=pack, rows_by_bank=rows,
                              words32=pack.n_words * pack.n_bits / 32.0,
                              fingerprint=tuple(fingerprint), evictable=True,
                              aux=aux, ecc_parity=parity,
                              scrubbed_s=fm.clock() if fm is not None
                              else 0.0)
        self._entries[key] = entry
        self.pins += 1
        _STATS["resident_pins"] += 1
        n_tiles = self.spec.plan(pack.n_words).n_tiles
        LEDGER.charge_load(pack.n_bits, pack.n_words, n_tiles=n_tiles)
        if n_ecc:
            LEDGER.charge_ecc(n_ecc, pack.n_words, n_tiles=n_tiles)
        return entry

    # -- ECC verify / scrub --------------------------------------------------

    def _verify(self, entry: ResidentEntry, decay_s: float = 0.0) -> bool:
        """One ECC pass over a protected entry: inject what the active
        fault model says the rows took (the per-get resident BER, plus
        `decay_s` seconds of retention decay on the scrub path), then
        SECDED-verify and repair. Returns False, after invalidating the
        entry, when the damage was uncorrectable (or raises
        UncorrectableFaultError under fail-stop semantics)."""
        from . import faults as faults_mod
        from .accounting import LEDGER
        from .planepack import ecc_check_correct, ecc_plane_count

        fm = faults_mod.active()
        planes = entry.pack.planes
        parity = entry.ecc_parity
        if fm is not None:
            planes, _ = fm.corrupt_resident(planes)
            if decay_s > 0.0:
                flips = fm.decay_bits(
                    decay_s, planes.numel() * 32 + parity.numel() * 32)
                if flips:
                    planes = fm.decay(planes, flips)
            entry.scrubbed_s = fm.clock()
        fixed, fixed_par, corrected, uncorrected = \
            ecc_check_correct(planes, parity)
        self.ecc_verifies += 1
        _STATS["ecc_verifies"] += 1
        LEDGER.charge_ecc(ecc_plane_count(entry.pack.n_bits),
                          entry.pack.n_words,
                          n_tiles=self.spec.plan(entry.pack.n_words).n_tiles)
        if corrected:
            self.ecc_corrected += corrected
            _STATS["ecc_corrected"] += corrected
        if uncorrected:
            self.ecc_uncorrected += uncorrected
            _STATS["ecc_uncorrected"] += uncorrected
        if fm is not None:
            fm.record_verify(corrected, uncorrected)
        if uncorrected:
            self._entries.pop(entry.key, None)
            self.invalidations += 1
            _STATS["resident_invalidations"] += 1
            if fm is not None and fm.config.raise_on_uncorrectable:
                raise faults_mod.UncorrectableFaultError(
                    f"resident entry {entry.key!r}: {uncorrected} "
                    f"uncorrectable bit(s); entry invalidated: re-pin and "
                    f"retry")
            return False
        if corrected or fm is not None:
            entry.pack = dataclasses.replace(entry.pack, planes=fixed)
            entry.ecc_parity = fixed_par
        return True

    def scrub(self) -> Dict[str, int]:
        """Walk every protected pin, integrate retention decay since its
        last verify, and repair what SECDED can (uncorrectable entries are
        invalidated, so the next `get` misses and rebuilds): the periodic
        pass a serving process runs between steps."""
        from . import faults as faults_mod

        fm = faults_mod.active()
        now = fm.clock() if fm is not None else 0.0
        corrected0 = self.ecc_corrected
        uncorrected0 = self.ecc_uncorrected
        scanned = 0
        dropped = 0
        for entry in list(self._entries.values()):
            if entry.ecc_parity is None:
                continue
            scanned += 1
            decay_s = max(0.0, now - entry.scrubbed_s) if fm is not None \
                else 0.0
            if not self._verify(entry, decay_s=decay_s):
                dropped += 1
        _STATS["ecc_scrubs"] += 1
        return {"scanned": scanned, "dropped": dropped,
                "corrected": self.ecc_corrected - corrected0,
                "uncorrected": self.ecc_uncorrected - uncorrected0}

    def reserve(self, key: Tuple, n_rows: int, bank: int = 0,
                words32: float = 0.0,
                fingerprint: Tuple = ()) -> ResidentEntry:
        """Claim `n_rows` on one bank without a pack; never evicted."""
        if key in self._entries:
            del self._entries[key]
        rows = {int(bank) % self.spec.banks: int(n_rows)}
        self._make_room(key, rows)
        entry = ResidentEntry(key=key, pack=None, rows_by_bank=rows,
                              words32=words32, fingerprint=tuple(fingerprint),
                              evictable=False)
        self._entries[key] = entry
        self.reserves += 1
        _STATS["resident_reserves"] += 1
        return entry

    def _make_room(self, key: Tuple, rows_by_bank: Dict[int, int]) -> None:
        if any(r > self.budget for r in rows_by_bank.values()):
            raise opset.CimOpError(
                f"resident entry {key!r} needs {max(rows_by_bank.values())} "
                f"rows on one bank but the resident budget is {self.budget} "
                f"(rows {self.spec.rows} - reserve {self.reserve_rows})")
        while not self.fits(rows_by_bank):
            victim = next((k for k, e in self._entries.items()
                           if e.evictable), None)
            if victim is None:
                raise opset.CimOpError(
                    f"resident entry {key!r} does not fit: occupancy "
                    f"{self.rows_per_bank()} of {self.budget} rows/bank is "
                    f"all reservations")
            del self._entries[victim]
            self.evictions += 1
            _STATS["resident_evictions"] += 1

    def release(self, key: Tuple) -> bool:
        return self._entries.pop(key, None) is not None

    def clear(self) -> None:
        self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries), "pins": self.pins,
                "reserves": self.reserves, "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "invalidations": self.invalidations,
                "ecc_verifies": self.ecc_verifies,
                "ecc_corrected": self.ecc_corrected,
                "ecc_uncorrected": self.ecc_uncorrected,
                "resident_rows": self.resident_rows}


#: every live ResidentSet (weak: test-local sets vanish with their tests)
_ALL_SETS: "weakref.WeakSet[ResidentSet]" = weakref.WeakSet()

#: process-wide counters surfaced through dispatch.cache_stats()
_STATS: Dict[str, int] = {}


def _reset_stats() -> None:
    _STATS.update(resident_pins=0, resident_reserves=0, resident_hits=0,
                  resident_misses=0, resident_evictions=0,
                  resident_invalidations=0,
                  ecc_verifies=0, ecc_corrected=0, ecc_uncorrected=0,
                  ecc_scrubs=0)


_reset_stats()

#: process-wide resident set per geometry (shared by weight pins and KV pages)
_RESIDENT_SETS: Dict[ArraySpec, ResidentSet] = {}

#: whether registry ResidentSets are created ECC-protected (the serve's
#: chaos phase turns this on; off keeps every ledger the plan's)
_DEFAULT_ECC: bool = False

#: process-wide spec override: the failover lever (see `set_current_spec`)
_CURRENT_SPEC: Optional[ArraySpec] = None


def set_resident_ecc(on: bool) -> bool:
    """Make future registry ResidentSets ECC-protected (or not); returns
    the previous setting. Existing sets keep their mode: call
    `clear_resident()` first to rebuild them protected."""
    global _DEFAULT_ECC
    prev = _DEFAULT_ECC
    _DEFAULT_ECC = bool(on)
    return prev


def resident_ecc_default() -> bool:
    return _DEFAULT_ECC


def set_current_spec(spec: Optional[ArraySpec]) -> Optional[ArraySpec]:
    """Install the process-wide spec override (None restores DEFAULT_SPEC
    resolution); returns the previous override."""
    global _CURRENT_SPEC
    prev = _CURRENT_SPEC
    _CURRENT_SPEC = spec
    return prev


def current_spec() -> ArraySpec:
    """What `spec=None` means right now: the override if one is installed,
    else the paper's DEFAULT_SPEC."""
    return _CURRENT_SPEC if _CURRENT_SPEC is not None else DEFAULT_SPEC


def spec_override() -> Optional[ArraySpec]:
    """The raw override (None when the process is healthy): what the layers
    whose `spec=None` means unbanked consult, so they never pick up
    DEFAULT_SPEC."""
    return _CURRENT_SPEC


def registry_reserve_rows(spec: ArraySpec) -> int:
    """Rows per bank the registry ResidentSet of `spec` keeps back for
    streamed access planes: a quarter of them."""
    return spec.rows // 4


def resident_set(spec: Optional[ArraySpec] = None) -> ResidentSet:
    """The process-wide ResidentSet for `spec` (`current_spec()` when None),
    keeping `registry_reserve_rows` as reserve for streamed access planes,
    ECC-protected when `set_resident_ecc(True)` was in force at creation."""
    spec = spec or current_spec()
    rs = _RESIDENT_SETS.get(spec)
    if rs is None:
        rs = _RESIDENT_SETS[spec] = ResidentSet(
            spec, reserve_rows=registry_reserve_rows(spec), ecc=_DEFAULT_ECC)
    return rs


def resident_rows_for(spec: Optional[ArraySpec]) -> int:
    """Busiest-bank occupancy of the registry set for `spec` — what the
    dispatcher folds into the combined `check_fits` budget."""
    rs = _RESIDENT_SETS.get(spec or current_spec())
    return rs.resident_rows if rs is not None else 0


def resident_stats() -> Dict[str, int]:
    """Aggregated pin/hit/eviction counters across every ResidentSet."""
    out = dict(_STATS)
    out["resident_entries"] = sum(len(s) for s in _ALL_SETS)
    out["resident_rows"] = max((s.resident_rows for s in _ALL_SETS),
                               default=0)
    return out


def clear_resident() -> None:
    """Drop every registry ResidentSet and zero the aggregate counters."""
    for rs in list(_ALL_SETS):
        rs.clear()
    _RESIDENT_SETS.clear()
    _reset_stats()
