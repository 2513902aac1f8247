"""ADRA senseline model: asymmetric dual-row activation on a 1T-FeFET column.

Port of `repro.core.array`. Implements the core mechanism of the paper (Sec.
III-A): during a CiM access the RBL is driven to V_READ, WL1 (operand A) is
asserted to V_GREAD1 and WL2 (operand B) to V_GREAD2 > V_GREAD1. The
senseline current is the sum of the two bitcell currents; because cell
current depends on both the stored bit and the wordline voltage, the four
input vectors (A,B) map ONE-TO-ONE onto four distinct I_SL values:

    I(0,0) < I(1,0) < I(0,1) < I(1,1)

(the symmetric scheme of prior work collapses (0,1) and (1,0)).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from .fefet import BiasConditions, FeFETParams, cell_current


@dataclasses.dataclass(frozen=True)
class AdraArrayConfig:
    """A rows x cols 1T-FeFET array with ADRA peripherals."""

    rows: int = 1024
    cols: int = 1024
    word_bits: int = 32
    device: FeFETParams = dataclasses.field(default_factory=FeFETParams)
    bias: BiasConditions = dataclasses.field(default_factory=BiasConditions)

    @property
    def words_per_row(self) -> int:
        return self.cols // self.word_bits


def senseline_current(a_bit, b_bit, cfg: AdraArrayConfig,
                      asymmetric: bool = True) -> torch.Tensor:
    """I_SL for a dual-row activation; broadcasts over array-shaped inputs
    and computes on their device.

    asymmetric=True  -> ADRA (V_GREAD1 on WL_A, V_GREAD2 on WL_B)
    asymmetric=False -> prior-work symmetric assertion (both at V_GREAD),
                        which exhibits the many-to-one mapping.
    """
    b = cfg.bias
    v1 = b.v_gread1 if asymmetric else b.v_gread
    v2 = b.v_gread2 if asymmetric else b.v_gread
    i_a = cell_current(a_bit, v1, b.v_read, cfg.device)
    i_b = cell_current(b_bit, v2, b.v_read, cfg.device)
    return i_a + i_b


def level_currents(cfg: AdraArrayConfig, asymmetric: bool = True,
                   device=None) -> torch.Tensor:
    """The four I_SL levels for input vectors (A,B) in order 00,10,01,11."""
    dev = resolve_device(device)
    a = torch.tensor([0, 1, 0, 1], device=dev)
    b = torch.tensor([0, 0, 1, 1], device=dev)
    return senseline_current(a, b, cfg, asymmetric=asymmetric)


def single_cell_read_current(bit, cfg: AdraArrayConfig) -> torch.Tensor:
    """Standard single-WL read at V_GREAD (for the near-memory baseline)."""
    b = cfg.bias
    return cell_current(bit, b.v_gread, b.v_read, cfg.device)


def rbl_discharge_voltage(i_sl: torch.Tensor, t_sense: float,
                          cfg: AdraArrayConfig,
                          c_bl_per_row: float = 0.18e-15) -> torch.Tensor:
    """Voltage-sensing view: RBL discharge dV = I_SL * t / C_BL.

    C_BL scales with the number of rows (drain-junction + wire capacitance per
    cell ~0.18 fF at 45 nm). Used to verify the > 50 mV voltage sense margin.
    """
    c_bl = c_bl_per_row * cfg.rows
    return i_sl * t_sense / c_bl
