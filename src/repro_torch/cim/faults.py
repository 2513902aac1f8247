"""Seeded deterministic fault injection for the CiM substrate.

Port of `repro.cim.faults`. FeFET arrays fail in characteristic ways:
transient sensing upsets (a bit flips during one access), retention decay
(pinned nonvolatile rows leak charge over seconds), stuck-at rows (a
wordline welded to 0/1) and whole-bank failures. This module models
all four as an overlay the rest of the stack opts into:

  * `install(FaultModel)` arms a process-wide model; `active()` is what the
    eager execution paths (`engine.execute`, `dispatch.execute_tiled`) and
    the resident region (`ResidentSet.get` / `scrub`) consult. With nothing
    installed every hook is a None-check.
  * Transient faults are injected only on eager accesses, never inside a
    schedule program (`macro.run_schedule_program` runs the side-effect-free
    `execute_traced` forms): the reference's programs are jitted, so its
    streamed faults never reach them, and a flip there would consume draws
    the reference never makes. Resident-plane faults always qualify, which
    is where ECC protection lives.
  * Everything is deterministic: one numpy PCG64 generator seeded from
    `FaultConfig.seed` (default: the `REPRO_CIM_FAULT_SEED` env var),
    advanced in the reference's call order, so the same seed and call
    sequence flip the reference's very bits. The draws are made on the
    host; the flips land on the planes' own device with one indexed XOR.

Counters (injected / detected / corrected / uncorrected) are charged into
the ledger (`charge_fault`) and aggregated process-wide here, so
`dispatch.cache_stats()` reports them beside its cache and residency
counters. `host_failure_hook` builds the `fault_hook` callables
`repro_torch.runtime.supervisor.Supervisor` restarts on, under the same seed.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import opset
from .accounting import LEDGER
from .planepack import popcount_total

#: env vars of the shared fault-seed convention (serving + training chaos)
ENV_SEED = "REPRO_CIM_FAULT_SEED"
ENV_BER = "REPRO_CIM_FAULT_BER"
ENV_RESIDENT_BER = "REPRO_CIM_FAULT_RESIDENT_BER"
ENV_RETENTION = "REPRO_CIM_FAULT_RETENTION"


class UncorrectableFaultError(opset.CimOpError):
    """An ECC verify found more errors than SECDED can repair and the
    installed FaultModel asked for fail-stop semantics. The stale entry has
    already been invalidated; re-running the step re-pins from the source
    (the serve engine's repair loop does exactly that)."""


def fault_seed(default: int = 0) -> int:
    """The process fault seed: REPRO_CIM_FAULT_SEED, else `default`."""
    raw = os.environ.get(ENV_SEED)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def _env_float(name: str, default: float = 0.0) -> float:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Knobs of one deterministic fault campaign.

    ber           : per-bit flip probability on each streamed operand of an
                    eager access (unprotected: counted `injected`).
    resident_ber  : per-bit flip probability applied to a pinned entry's
                    plane stack on every resident `get` (ECC verifies it).
    retention_per_s : expected plane-bit flips per second pinned, applied by
                    the periodic scrub pass.
    stuck          : ((bank, plane, value), ...) stuck-at rows forced on
                    streamed tiled accesses of the named bank.
    kill_bank_at  : (decode_step, bank): `on_step(step)` marks `bank` dead
                    once `step` is reached.
    raise_on_uncorrectable : `ResidentSet.get` raises
                    UncorrectableFaultError instead of invalidate-and-miss.
    uncorrectable_at_verify : verify indices (0-based, process order) hit
                    with a forced double flip in one column.
    """

    seed: int = 0
    ber: float = 0.0
    resident_ber: float = 0.0
    retention_per_s: float = 0.0
    stuck: Tuple[Tuple[int, int, int], ...] = ()
    kill_bank_at: Optional[Tuple[int, int]] = None
    raise_on_uncorrectable: bool = False
    uncorrectable_at_verify: Tuple[int, ...] = ()

    @classmethod
    def from_env(cls, **overrides) -> "FaultConfig":
        base = dict(seed=fault_seed(), ber=_env_float(ENV_BER),
                    resident_ber=_env_float(ENV_RESIDENT_BER),
                    retention_per_s=_env_float(ENV_RETENTION))
        base.update(overrides)
        return cls(**base)


def flip_bits(planes: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """A copy of `planes` (int32 holding uint32 patterns) with the flat bit
    positions `idx` (bit i % 32 of word i // 32, C order) flipped. A
    position drawn twice flips twice, as the reference's loop does: the
    per-word masks are XOR-reduced on the host and applied with one
    indexed XOR over distinct words."""
    out = planes.contiguous().clone()
    idx = np.asarray(idx, dtype=np.int64)
    if idx.size == 0:
        return out
    words, inv = np.unique(idx // 32, return_inverse=True)
    masks = np.zeros(words.shape[0], dtype=np.uint32)
    np.bitwise_xor.at(masks, inv, np.left_shift(
        np.uint32(1), (idx % 32).astype(np.uint32)))
    flat = out.view(-1)
    w = torch.from_numpy(words).to(out.device)
    flat[w] = flat[w] ^ torch.from_numpy(masks.view(np.int32)).to(out.device)
    return out


class FaultModel:
    """One seeded fault campaign: deterministic injection + counters."""

    def __init__(self, config: Optional[FaultConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config or FaultConfig()
        self.clock = clock
        self.rng = np.random.Generator(np.random.PCG64(self.config.seed))
        self.dead_banks: Tuple[int, ...] = ()
        self.injected = 0          # bits flipped into live data
        self.detected = 0          # bits ECC saw (corrected + uncorrected)
        self.corrected = 0
        self.uncorrected = 0
        self.verifies = 0          # ECC verify passes executed
        self.bank_kills = 0

    # -- bank lifecycle ------------------------------------------------------

    def kill_bank(self, bank: int) -> None:
        if bank not in self.dead_banks:
            self.dead_banks = self.dead_banks + (int(bank),)
            self.bank_kills += 1

    def on_step(self, step: int) -> None:
        """Advance scheduled faults to `step` (the serve loop's clock)."""
        ka = self.config.kill_bank_at
        if ka is not None and step >= ka[0]:
            self.kill_bank(ka[1])

    # -- plane corruption ----------------------------------------------------

    def _flip_planes(self, planes: torch.Tensor, ber: float
                     ) -> Tuple[torch.Tensor, int]:
        """Flip ~Binomial(total_bits, ber) uniformly placed bits."""
        total_bits = planes.numel() * 32
        n = int(self.rng.binomial(total_bits, ber)) if ber > 0 else 0
        if n == 0:
            return planes, 0
        idx = self.rng.integers(0, total_bits, size=n)
        return flip_bits(planes, idx), n

    def _charge_injected(self, n: int) -> None:
        self.injected += n
        _STATS["fault_injected"] += n
        LEDGER.charge_fault(injected=n)

    def corrupt_streamed(self, planes: torch.Tensor, plan=None
                         ) -> Tuple[torch.Tensor, int]:
        """Transient faults on one streamed operand of an eager access:
        BER flips plus stuck-at rows of the banks `plan` places tiles on.
        Returns (possibly new) planes and the number of bits injected."""
        arr, n = self._flip_planes(planes, self.config.ber)
        if self.config.stuck and plan is not None:
            arr = arr.contiguous().clone() if arr is planes else arr
            w = arr.shape[1]
            live = torch.tensor(plan.live_banks, device=arr.device)
            lane = torch.arange(w, device=arr.device)
            bank_of_lane = live[(lane // plan.lanes_per_tile) % live.numel()]
            for bank, plane, value in self.config.stuck:
                if plane >= arr.shape[0]:
                    continue
                before = arr[plane].clone()
                fill = torch.full_like(before, -1 if value else 0)
                arr[plane] = torch.where(bank_of_lane == bank, fill, before)
                n += int(popcount_total(before ^ arr[plane]))
        if n:
            self._charge_injected(n)
        return arr, n

    def corrupt_resident(self, planes: torch.Tensor
                         ) -> Tuple[torch.Tensor, int]:
        """Per-`get` decay on a pinned entry's planes (ECC territory)."""
        arr, n = self._flip_planes(planes, self.config.resident_ber)
        if self.verifies in self.config.uncorrectable_at_verify \
                and arr.shape[0] >= 2:
            # forced double error in one column: same lane bit, two planes
            arr = flip_bits(arr, np.array([0, arr.shape[1] * 32]))
            n += 2
        if n:
            self._charge_injected(n)
        return arr, n

    def decay_bits(self, seconds: float, total_bits: int) -> int:
        """Retention-decay flips accumulated over `seconds` pinned."""
        lam = self.config.retention_per_s * max(0.0, seconds)
        if lam <= 0.0:
            return 0
        return min(int(self.rng.poisson(lam)), total_bits)

    def decay(self, planes: torch.Tensor, flips: int) -> torch.Tensor:
        """`flips` retention flips at uniform positions of `planes`."""
        idx = self.rng.integers(0, planes.numel() * 32, size=flips)
        self._charge_injected(flips)
        return flip_bits(planes, idx)

    # -- ECC outcome accounting ---------------------------------------------

    def record_verify(self, corrected: int, uncorrected: int) -> None:
        self.verifies += 1
        _STATS["fault_verifies"] += 1
        if corrected:
            self.corrected += corrected
            self.detected += corrected
            _STATS["fault_corrected"] += corrected
            _STATS["fault_detected"] += corrected
        if uncorrected:
            self.uncorrected += uncorrected
            self.detected += uncorrected
            _STATS["fault_uncorrected"] += uncorrected
            _STATS["fault_detected"] += uncorrected
        LEDGER.charge_fault(detected=corrected + uncorrected,
                            corrected=corrected, uncorrected=uncorrected)

    def stats(self) -> Dict[str, int]:
        return {"injected": self.injected, "detected": self.detected,
                "corrected": self.corrected,
                "uncorrected": self.uncorrected,
                "verifies": self.verifies, "bank_kills": self.bank_kills,
                "dead_banks": list(self.dead_banks)}


# ---------------------------------------------------------------------------
# the process-wide overlay
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultModel] = None

#: process-wide counters surfaced through dispatch.cache_stats()
_STATS: Dict[str, int] = {}


def _reset_stats() -> None:
    _STATS.update(fault_injected=0, fault_detected=0, fault_corrected=0,
                  fault_uncorrected=0, fault_verifies=0)


_reset_stats()


def install(model: FaultModel) -> FaultModel:
    """Arm `model` as the process fault overlay (replacing any other)."""
    global _ACTIVE
    _ACTIVE = model
    return model


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FaultModel]:
    return _ACTIVE


def fault_stats() -> Dict[str, int]:
    """Aggregated process-wide injection/ECC counters."""
    return dict(_STATS)


def reset_fault_stats() -> None:
    _reset_stats()


class faults:
    """Context manager: install a FaultModel for a with-block.

        with faults(FaultConfig(seed=7, resident_ber=1e-3)) as fm:
            ...
    """

    def __init__(self, config_or_model, clock=time.monotonic):
        self.model = config_or_model if isinstance(config_or_model,
                                                   FaultModel) \
            else FaultModel(config_or_model, clock=clock)
        self._prev: Optional[FaultModel] = None

    def __enter__(self) -> FaultModel:
        global _ACTIVE
        self._prev = _ACTIVE
        _ACTIVE = self.model
        return self.model

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE = self._prev
        return None


# ---------------------------------------------------------------------------
# the training side of the shared seed convention
# ---------------------------------------------------------------------------


def host_failure_hook(fail_steps: Tuple[int, ...] = (),
                      p_fail: float = 0.0,
                      seed: Optional[int] = None
                      ) -> Callable[[int], None]:
    """A `Supervisor(fault_hook=...)` callable under the shared convention.

    Raises SimulatedHostFailure at every step in `fail_steps`, plus with
    probability `p_fail` per step, decided by a generator seeded from
    (seed or REPRO_CIM_FAULT_SEED, step): a given (seed, step) either
    always fails or never does, so restarts replay deterministically. Each
    step fails at most once."""
    from repro_torch.runtime.supervisor import SimulatedHostFailure

    base = fault_seed() if seed is None else int(seed)
    fail = frozenset(int(s) for s in fail_steps)
    fired = set()

    def hook(step: int) -> None:
        if step in fail and step not in fired:
            fired.add(step)
            raise SimulatedHostFailure(
                f"injected host failure at step {step} (seed {base})")
        if p_fail > 0.0 and step not in fired:
            g = np.random.Generator(np.random.PCG64((base, int(step))))
            if g.random() < p_fail:
                fired.add(step)
                raise SimulatedHostFailure(
                    f"injected host failure at step {step} (seed {base})")

    return hook
