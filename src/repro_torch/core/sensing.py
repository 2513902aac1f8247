"""Sense amplifiers and reference generation for ADRA (paper Fig. 3(b)).

Port of `repro.core.sensing`. Three SAs share the senseline:
  SA_OR  : ref between I(0,0) and I(1,0)   -> outputs A+B  (OR)
  SA_B   : ref between I(1,0) and I(0,1)   -> outputs B
  SA_AND : ref between I(0,1) and I(1,1)   -> outputs AB   (AND)

Complements are available from the differential SA outputs. The fourth signal,
A, is recovered with one OAI21 gate (paper Sec. III-A):

    A = NOT( NAND(A,B) * (B + NOR(A,B)) )

Both current-based and voltage-based sensing are supported; voltage sensing
compares the RBL discharge against voltage references with the same level
ordering.

The references depend on the static device config only. The reference
evaluates them at trace time; here they are computed once per config, in
float32 on the CPU, so they do not depend on the device a sense runs on and
reading them costs no device sync.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from .array import AdraArrayConfig, level_currents, rbl_discharge_voltage


class SenseOutputs(NamedTuple):
    """Digital outputs of the three SAs (plus derived A) for each column."""

    or_: torch.Tensor       # A + B
    and_: torch.Tensor      # A * B
    b: torch.Tensor         # B (the word under V_GREAD2)
    a: torch.Tensor         # recovered via the OAI21 gate


@dataclasses.dataclass(frozen=True)
class SenseReferences:
    """Reference currents (A) placed midway between adjacent I_SL levels."""

    i_ref_or: float
    i_ref_b: float
    i_ref_and: float

    @classmethod
    def from_config(cls, cfg: AdraArrayConfig) -> "SenseReferences":
        return _references(cfg)


@functools.lru_cache(maxsize=64)
def _references(cfg: AdraArrayConfig) -> SenseReferences:
    # the reference's arithmetic on the same float32 levels:
    # [I00, I10, I01, I11] as numpy float32, midpoints as it takes them
    lv = level_currents(cfg, asymmetric=True, device="cpu").numpy()
    return SenseReferences(
        i_ref_or=float(0.5 * (lv[0] + lv[1])),
        i_ref_b=float(0.5 * (lv[1] + lv[2])),
        i_ref_and=float(0.5 * (lv[2] + lv[3])),
    )


def current_sense_margins(cfg: AdraArrayConfig, device=None) -> torch.Tensor:
    """Adjacent-level separations [I10-I00, I01-I10, I11-I01] (amperes).

    The paper reports > 1 uA margin for current-based sensing.
    """
    lv = level_currents(cfg, asymmetric=True, device=device)
    return torch.diff(lv)


def voltage_sense_margins(cfg: AdraArrayConfig, t_sense: float = 1.0e-9,
                          device=None) -> torch.Tensor:
    """Adjacent-level RBL discharge separations (volts); paper: > 50 mV."""
    lv = level_currents(cfg, asymmetric=True, device=device)
    dv = rbl_discharge_voltage(lv, t_sense, cfg)
    return torch.diff(dv)


def oai21_recover_a(or_, and_, b):
    """A = NOT( NOT(AND) * (B + NOT(OR)) )  -- one OAI21 on the SA outputs."""
    nand_ = 1 - and_
    nor_ = 1 - or_
    return 1 - (nand_ & (b | nor_))


def sense(i_sl: torch.Tensor, refs: SenseReferences) -> SenseOutputs:
    """Threshold the senseline current against the three references."""
    or_ = (i_sl > refs.i_ref_or).to(torch.int32)
    b = (i_sl > refs.i_ref_b).to(torch.int32)
    and_ = (i_sl > refs.i_ref_and).to(torch.int32)
    a = oai21_recover_a(or_, and_, b)
    return SenseOutputs(or_=or_, and_=and_, b=b, a=a)


def symmetric_sense_is_ambiguous(cfg: AdraArrayConfig, device=None) -> bool:
    """Demonstrates the many-to-one problem of prior (symmetric) CiM:
    I(0,1) == I(1,0) to within sensing resolution, so (0,1) and (1,0)
    cannot be distinguished and non-commutative functions are infeasible."""
    lv = level_currents(cfg, asymmetric=False, device=device)
    sep_mid = abs(float(lv[2] - lv[1]))
    # sub-1% of the smallest commutative-level gap == indistinguishable
    gap = min(float(lv[1] - lv[0]), float(lv[3] - lv[2]))
    return sep_mid < 0.01 * gap
