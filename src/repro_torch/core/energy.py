"""Component-level energy/latency/EDP model for ADRA (paper Sec. IV).

Port of the part of `repro.core.energy` that `repro_torch.cim.accounting`
reads: the three sensing schemes at a given row count and the physical-unit
helpers. The frequency/parallelism sweeps and the paper anchor table wait.
Units: internal energy unit = one standard read of a 32-bit word at 1024
rows; latency unit = one read at 1024 rows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

E0_FJ = 120.0      # fJ per 32-bit-word standard read @1024 rows
T0_NS = 2.0        # ns per standard read @1024 rows

V_DD = 1.0
DELTA_SENSE = 0.1231
READ_SWING = 2 * DELTA_SENSE


@dataclasses.dataclass(frozen=True)
class OpCosts:
    """Energy & latency of one operation on a 32-bit word (internal units)."""

    energy: float
    latency: float
    breakdown: Dict[str, float]

    @property
    def edp(self) -> float:
        return self.energy * self.latency


@dataclasses.dataclass(frozen=True)
class SchemeResult:
    """read / ADRA-CiM / near-memory-baseline costs + derived paper metrics."""

    read: OpCosts
    cim: OpCosts
    baseline: OpCosts

    @property
    def speedup(self) -> float:
        return self.baseline.latency / self.cim.latency

    @property
    def energy_decrease_pct(self) -> float:
        return 100.0 * (1.0 - self.cim.energy / self.baseline.energy)

    @property
    def edp_decrease_pct(self) -> float:
        return 100.0 * (1.0 - self.cim.edp / self.baseline.edp)


def _nhat(rows: int) -> float:
    return rows / 1024.0


_CS = dict(
    e_bl=0.91, e_wl=0.02, e_flow=0.03, e_sa=0.04, e_wl_cim=0.0338,
    e_flow_cim=0.05, e_sa_cim=0.12, e_cm=0.126, e_nc=0.108,
    t_fix=0.30, t_bl=0.70, t_cm=0.05, t_nc=0.04,
)


def current_sensing(rows: int = 1024) -> SchemeResult:
    n = _nhat(rows)
    c = _CS
    e_read = c["e_bl"] * n + c["e_wl"] + c["e_flow"] + c["e_sa"]
    e_cim = c["e_bl"] * n + c["e_wl_cim"] + c["e_flow_cim"] + c["e_sa_cim"] + c["e_cm"]
    e_base = 2.0 * e_read + c["e_nc"]
    t_read = c["t_fix"] + c["t_bl"] * n
    t_cim = t_read + c["t_cm"]
    t_base = 2.0 * t_read + c["t_nc"]
    return SchemeResult(
        read=OpCosts(e_read, t_read, {"bitline": c["e_bl"] * n, "wordline": c["e_wl"],
                                      "flow": c["e_flow"], "periph": c["e_sa"]}),
        cim=OpCosts(e_cim, t_cim, {"bitline": c["e_bl"] * n, "wordline": c["e_wl_cim"],
                                   "flow": c["e_flow_cim"],
                                   "periph": c["e_sa_cim"] + c["e_cm"]}),
        baseline=OpCosts(e_base, t_base, {"two_reads": 2 * e_read,
                                          "near_compute": c["e_nc"]}),
    )


_VS = dict(
    c_bl=0.93, s_read=0.07, s1_cim=0.167, s2_cim=0.25, e_nc=0.108,
    t1_f=0.45, t1_b=0.55, t1_x=0.20, t1_nc=0.04,
    t2_f=0.30, t2_b=0.70, t2_cm=0.045, t2_nc=0.04,
    p_leak=(0.93 + 0.25 - (3 * 0.93 * READ_SWING / V_DD + 0.167)) * 7.53e6,
)


def voltage_scheme1(rows: int = 1024,
                    freq_hz: Optional[float] = None) -> SchemeResult:
    """Scheme 1: RBL held precharged; CiM needs 6*Delta vs a read's 2*Delta."""
    n = _nhat(rows)
    c = _VS
    e_bl_read = c["c_bl"] * (READ_SWING / V_DD) * n
    e_bl_cim = 3.0 * e_bl_read
    leak = (c["p_leak"] / freq_hz) if freq_hz else 0.0
    e_read = e_bl_read + c["s_read"] + leak
    e_cim = e_bl_cim + c["s1_cim"] + leak
    e_base = 2.0 * (e_bl_read + c["s_read"]) + c["e_nc"] + 2.0 * leak
    t_read = c["t1_f"] + c["t1_b"] * n
    t_cim = t_read + c["t1_x"]
    t_base = 2.0 * t_read + c["t1_nc"]
    return SchemeResult(
        read=OpCosts(e_read, t_read, {"bitline": e_bl_read, "periph": c["s_read"],
                                      "leak": leak}),
        cim=OpCosts(e_cim, t_cim, {"bitline": e_bl_cim, "periph": c["s1_cim"],
                                   "leak": leak}),
        baseline=OpCosts(e_base, t_base, {"two_reads": 2 * (e_bl_read + c["s_read"]),
                                          "near_compute": c["e_nc"], "leak": 2 * leak}),
    )


def voltage_scheme2(rows: int = 1024) -> SchemeResult:
    """Scheme 2: RBL at 0 during hold, charged to V_DD for every operation."""
    n = _nhat(rows)
    c = _VS
    e_bl = c["c_bl"] * n
    e_read = e_bl + c["s_read"]
    e_cim = e_bl + c["s2_cim"]
    e_base = 2.0 * e_read + c["e_nc"]
    t_read = c["t2_f"] + c["t2_b"] * n
    t_cim = t_read + c["t2_cm"]
    t_base = 2.0 * t_read + c["t2_nc"]
    return SchemeResult(
        read=OpCosts(e_read, t_read, {"bitline": e_bl, "periph": c["s_read"]}),
        cim=OpCosts(e_cim, t_cim, {"bitline": e_bl, "periph": c["s2_cim"]}),
        baseline=OpCosts(e_base, t_base, {"two_reads": 2 * e_read,
                                          "near_compute": c["e_nc"]}),
    )


def to_fj(e_internal: float) -> float:
    return e_internal * E0_FJ

