"""Component-level energy/latency/EDP model for ADRA (paper Sec. IV).

Port of `repro.core.energy`: the three sensing schemes at a given row
count, the scheme-1/scheme-2 crossovers in operating frequency (Fig. 5a)
and CiM parallelism (Fig. 5b), the array-size sweeps, the EDP summary, the
physical-unit helpers and the paper's anchor table. Pure Python, no
tensors. Units: internal energy unit = one standard read of a 32-bit word
at 1024 rows; latency unit = one read at 1024 rows. Relative claims
(speedups, percentage deltas, crossovers) are unit-free.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

E0_FJ = 120.0      # fJ per 32-bit-word standard read @1024 rows
T0_NS = 2.0        # ns per standard read @1024 rows

V_DD = 1.0
DELTA_SENSE = 0.1231
READ_SWING = 2 * DELTA_SENSE  # a standard read develops 2*Delta on the RBL
CIM_SWING = 6 * DELTA_SENSE   # ADRA separates 4 levels: 6*Delta


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



# ---------------------------------------------------------------------------
# Fig 5(a): per-op energy vs operating frequency (leakage trade-off)
# ---------------------------------------------------------------------------


def scheme_energies_vs_frequency(freq_hz: float,
                                 rows: int = 1024) -> Dict[str, float]:
    """Per-CiM-op energy of both schemes at a given op frequency: scheme 1
    pays hold-state leakage between ops (p_leak / f), scheme 2 the full RBL
    charge every op but almost no hold leakage."""
    s1 = voltage_scheme1(rows, freq_hz=freq_hz)
    s2 = voltage_scheme2(rows)
    return {"scheme1": s1.cim.energy, "scheme2": s2.cim.energy}


def frequency_crossover_hz(rows: int = 1024) -> float:
    """Frequency below which scheme 2 is more energy-efficient (paper:
    7.53 MHz)."""
    e1_dyn = voltage_scheme1(rows).cim.energy
    e2_dyn = voltage_scheme2(rows).cim.energy
    return _VS["p_leak"] / (e2_dyn - e1_dyn)


# ---------------------------------------------------------------------------
# Fig 5(b): per-row-op energy vs CiM parallelism P = N_w,CiM / N_w,TOT
# ---------------------------------------------------------------------------


def scheme_energies_vs_parallelism(p: float, rows: int = 1024,
                                   n_words: int = 32) -> Dict[str, float]:
    """Energy per row operation when a fraction p of the row's words
    compute. Scheme 1's half-selected words undergo a pseudo-CiM discharge
    (~2*Delta) that must be recharged, a waste proportional to (1 - p);
    scheme 2 charges only the selected words' RBLs (paper: crossover at
    P ~ 42%)."""
    n = _nhat(rows)
    c = _VS
    sel_bl = 3.0 * c["c_bl"] * (READ_SWING / V_DD) * n      # 6*Delta swing
    half_bl = c["c_bl"] * (READ_SWING / V_DD) * n           # 2*Delta
    e1 = n_words * (p * (sel_bl + c["s1_cim"]) + (1.0 - p) * half_bl)
    e2 = n_words * p * (c["c_bl"] * n + c["s2_cim"])
    return {"scheme1": e1, "scheme2": e2}


def parallelism_crossover(rows: int = 1024) -> float:
    """P below which scheme 2 wins (paper: ~42%): 80 bisection steps."""
    lo, hi = 1e-4, 1.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        e = scheme_energies_vs_parallelism(mid, rows)
        if e["scheme1"] > e["scheme2"]:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


# ---------------------------------------------------------------------------
# sweeps (the paper's figures) + physical-unit helpers
# ---------------------------------------------------------------------------

ARRAY_SIZES = (256, 512, 1024, 2048)


def sweep(scheme: str, sizes=ARRAY_SIZES) -> Dict[int, SchemeResult]:
    fn = {"current": current_sensing, "scheme1": voltage_scheme1,
          "scheme2": voltage_scheme2}[scheme]
    return {s: fn(s) for s in sizes}


def to_ns(t_internal: float) -> float:
    return t_internal * T0_NS


def edp_summary(rows: int = 1024) -> Dict[str, Dict[str, float]]:
    """The paper's headline table: EDP decrease per sensing scheme."""
    out = {}
    for name, fn in [("current", current_sensing),
                     ("scheme1", voltage_scheme1),
                     ("scheme2", voltage_scheme2)]:
        r = fn(rows)
        out[name] = {
            "speedup": r.speedup,
            "energy_decrease_pct": r.energy_decrease_pct,
            "edp_decrease_pct": r.edp_decrease_pct,
        }
    return out


# ---------------------------------------------------------------------------
# paper-reported anchors (one source of truth for figure scripts and docs)
# ---------------------------------------------------------------------------

#: the ADRA paper's Figs. 4-7 figures as (lo, hi) ranges per scheme and
#: metric (point anchors have lo == hi)
PAPER_ANCHORS: Dict[str, Dict[str, tuple]] = {
    "current": {
        "energy_decrease_pct": (41.18, 41.18),   # @1024 rows
        "speedup": (1.94, 1.94),
        "edp_decrease_pct": (69.04, 69.04),
    },
    "scheme1": {
        "bitline_ratio_cim_over_read": (3.0, 3.0),   # 6*Delta vs 2*Delta
        "energy_decrease_pct": (-23.0, -20.0),       # CiM costs more
        "speedup": (1.57, 1.73),
        "edp_decrease_pct": (23.26, 28.81),
    },
    "scheme2": {
        "energy_decrease_pct": (35.5, 45.8),
        "speedup": (1.945, 1.983),
        "edp_decrease_pct": (66.83, 72.6),
    },
    "crossover": {
        "frequency_mhz": (7.53, 7.53),
        "parallelism": (0.42, 0.42),
    },
}


def anchor_note(scheme: str, metric: str, at_1024: bool = False,
                suffix: str = "") -> str:
    """The figure scripts' annotation string for one paper anchor."""
    lo, hi = PAPER_ANCHORS[scheme][metric]
    where = "paper@1024" if at_1024 else "paper"
    body = f"{lo:g}" if lo == hi else f"{lo:g}..{hi:g}"
    return f"{where}: {body}{suffix}"
