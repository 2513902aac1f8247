"""HZO FeFET device model for the ADRA array.

Port of `repro.core.fefet`. The paper models the ferroelectric layer with
Miller's equations (Preisach-based domain distribution) in Verilog-A on top
of a 45 nm PTM FET; this module carries the same behaviour in PyTorch:

  P(E)   = Ps * tanh[(E +/- Ec) / (2*sigma)]          (eq. 1)
  sigma  = alpha / ln[(Ps + Pr) / (Ps - Pr)]          (eq. 2)

The retained +/-P state shifts the FET threshold voltage; read currents follow
a smooth EKV-style I-V so that both the super-threshold (LRS at V_GREAD) and
the deep-subthreshold (HRS) regimes are captured by one expression.

All quantities are SI unless noted, computed in float32 (the reference runs
without x64). Calibration targets (paper Sec. IV):
  V_READ = 1.0 V, V_GREAD2 = 1.0 V, V_GREAD1 = 0.83 V,
  four distinct I_SL levels with > 1 uA current sense margin and > 50 mV
  voltage sense margin.

Functions on tensors compute on their inputs' device; `read_currents`, which
builds its tensors from nothing, takes a `device` (the card unless the caller
asks for the CPU).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import resolve_device

EPS0 = 8.8541878128e-12          # vacuum permittivity, F/m

# ---------------------------------------------------------------------------
# Ferroelectric layer (Miller / Preisach average-polarization model)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FEParams:
    """Hf0.5Zr0.5O2 (HZO) ferroelectric parameters (paper Fig. 2(b) regime).

    Values follow the experimentally-calibrated HZO FeFET literature the paper
    cites ([17] Ni et al. VLSI'18, [18] Chatterjee et al. EDL'17).
    """

    Ps: float = 23.0e-2          # saturation polarization, C/m^2  (23 uC/cm^2)
    Pr: float = 17.0e-2          # remanent polarization,   C/m^2  (17 uC/cm^2)
    Ec: float = 1.0e8            # coercive field, V/m             (1 MV/cm)
    alpha: float = 2.5e7         # material-specific spread parameter, V/m
    eps_r: float = 32.0          # background relative permittivity of HZO
    t_fe: float = 8.0e-9         # FE layer thickness, m
    tau: float = 50.0e-9         # polarization response lag, s

    @property
    def sigma(self) -> float:
        """Eq. (2): sigma = alpha * ln[(Ps+Pr)/(Ps-Pr)]^-1."""
        return self.alpha / math.log((self.Ps + self.Pr) / (self.Ps - self.Pr))

    @property
    def coercive_voltage(self) -> float:
        return self.Ec * self.t_fe

    @property
    def c_fe_linear(self) -> float:
        """Background (linear) FE capacitance per unit area, C_B = eps0*eps_r/t_fe."""
        return EPS0 * self.eps_r / self.t_fe


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def polarization(v_fe, fe: FEParams, branch: int = +1) -> torch.Tensor:
    """Average polarization from Miller's equation (eq. 1).

    branch = +1 selects the ascending saturation loop branch (E - Ec), -1 the
    descending branch (E + Ec). Static reads sit on the retained branch.
    """
    e_fe = _f32(v_fe) / fe.t_fe
    shift = -branch * fe.Ec
    return fe.Ps * torch.tanh((e_fe + shift) / (2.0 * fe.sigma))


def fe_charge(v_fe, fe: FEParams, branch: int = +1) -> torch.Tensor:
    """Total FE charge density Q = eps0*eps_r*E + P (paper Sec. II-C)."""
    e_fe = _f32(v_fe) / fe.t_fe
    return EPS0 * fe.eps_r * e_fe + polarization(v_fe, fe, branch)


def fe_capacitance(v_fe, fe: FEParams, branch: int = +1) -> torch.Tensor:
    """C_FE = dQ/dV = C_B + C_P, evaluated analytically."""
    e_fe = _f32(v_fe) / fe.t_fe
    shift = -branch * fe.Ec
    sech2 = 1.0 / torch.cosh((e_fe + shift) / (2.0 * fe.sigma)) ** 2
    c_p = fe.Ps * sech2 / (2.0 * fe.sigma * fe.t_fe)
    return fe.c_fe_linear + c_p


# ---------------------------------------------------------------------------
# FeFET: FE layer in the gate stack of a 45 nm FET
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FeFETParams:
    """1T FeFET bitcell parameters.

    The retained polarization state shifts the effective threshold voltage:
    +P (LRS, logic '1') lowers V_T, -P (HRS, logic '0') raises it. The memory
    window is calibrated to the paper's bias points: at V_GREAD1 = 0.83 V and
    V_GREAD2 = 1.0 V an LRS cell conducts strongly while an HRS cell stays in
    deep subthreshold, producing the I_SL ordering of Fig. 3(c).
    """

    fe: FEParams = dataclasses.field(default_factory=FEParams)
    vt_lrs: float = 0.25         # V_T with +P retained (low-resistance state)
    vt_hrs: float = 1.45         # V_T with -P retained (high-resistance state)
    k_beta: float = 3.2e-4       # transconductance factor, A/V^2 (45nm, W/L~4)
    n_ss: float = 1.45           # subthreshold slope factor
    lambda_ch: float = 0.08      # channel-length modulation, 1/V
    temp_vt: float = 0.02585     # thermal voltage at 300 K, V

    @property
    def memory_window(self) -> float:
        return self.vt_hrs - self.vt_lrs


def drain_current(v_gs: torch.Tensor, v_ds: torch.Tensor, v_t: torch.Tensor,
                  p: FeFETParams) -> torch.Tensor:
    """Smooth EKV-style I-V: valid from deep subthreshold to strong inversion.

    I_D = 2 n k vt^2 * [ln(1 + exp((Vgs - Vt)/(2 n vt)))]^2
          * (1 - exp(-Vds/vt)) * (1 + lambda Vds)
    """
    vt = p.temp_vt
    x = (v_gs - v_t) / (2.0 * p.n_ss * vt)
    # log1p(exp(x)) with the reference's overflow-safe form (not
    # F.softplus, whose threshold and form differ)
    soft = torch.where(x > 30.0, x, torch.log1p(torch.exp(
        torch.clamp(x, max=30.0))))
    i_sat = 2.0 * p.n_ss * p.k_beta * vt**2 * soft**2
    return i_sat * (1.0 - torch.exp(-v_ds / vt)) * (1.0 + p.lambda_ch * v_ds)


def cell_current(stored_bit, v_wl, v_rbl, p: FeFETParams) -> torch.Tensor:
    """Read current of one 1T FeFET bitcell, on `stored_bit`'s device.

    stored_bit: 1 -> +P retained (LRS), 0 -> -P retained (HRS).
    v_wl: wordline (gate) voltage; v_rbl: read-bitline (drain) voltage.
    """
    bit = torch.as_tensor(stored_bit)
    v_t = torch.where(bit > 0, p.vt_lrs, p.vt_hrs).to(torch.float32)
    return drain_current(_f32(v_wl, bit.device), _f32(v_rbl, bit.device),
                         v_t, p)


# Convenience: the paper's bias set -------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BiasConditions:
    """Paper Sec. IV bias conditions."""

    v_read: float = 1.0          # RBL drive
    v_gread: float = 1.0         # standard read wordline voltage (= V_GREAD2)
    v_gread1: float = 0.83       # ADRA: WL of word A
    v_gread2: float = 1.0        # ADRA: WL of word B
    v_set: float = 3.7
    v_reset: float = -5.0


def read_currents(p: FeFETParams = FeFETParams(), bias: float = 1.0,
                  device=None) -> torch.Tensor:
    """[I_HRS, I_LRS] at wordline voltage `bias` (V_DS = V_READ = 1 V)."""
    bits = torch.tensor([0, 1], device=resolve_device(device))
    return cell_current(bits, bias, 1.0, p)


def write_polarization(v_gs: float, p: FeFETParams) -> int:
    """Static write model: V_GS > +Vc writes +P (LRS, '1');
    V_GS < -Vc writes -P (HRS, '0'); otherwise state is retained (-1)."""
    vc = p.fe.coercive_voltage
    if v_gs > vc:
        return 1
    if v_gs < -vc:
        return 0
    return -1
