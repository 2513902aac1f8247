"""PlanePack: packed bit-plane tensor — the CiM engine's working format.

Port of `repro.cim.planepack` (the pack and its zero-access peripherals;
the SECDED helpers wait for the fault layer). It carries the packed plane
stack — an int32 tensor [n_bits, W] holding uint32 bit patterns, plane p =
bit p of 32 words per lane element — plus the metadata (n_bits,
signedness, logical shape) needed to re-assemble integers, so chained CiM
ops stay packed between calls.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.bitplane import (_pack_lanes, pack_bitplanes,
                                       unpack_bitplanes, unpack_lanes)


def lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32-held uint32 words by 0 < k < 32."""
    return (x >> k) & ((1 << (32 - k)) - 1)


@dataclasses.dataclass(frozen=True)
class PlanePack:
    """Packed bit-plane representation of an integer tensor.

    planes : int32[n_bits, W] — plane p, lane word w, bit j holds bit p of
             logical element 32*w + j (LSB-first planes, two's complement).
    n_bits : word width (number of planes).
    signed : whether the MSB plane is a two's-complement sign plane.
    shape  : logical tensor shape (prod(shape) = number of valid words;
             the lane dim is padded to a multiple of 32).
    """

    planes: torch.Tensor
    n_bits: int
    signed: bool
    shape: Tuple[int, ...]

    # -- construction / materialization ------------------------------------
    @classmethod
    def pack(cls, x: torch.Tensor, n_bits: int,
             signed: bool = True) -> "PlanePack":
        """Integer tensor (any shape) -> PlanePack."""
        x = torch.as_tensor(x)
        return cls(planes=pack_bitplanes(x, n_bits), n_bits=n_bits,
                   signed=signed, shape=tuple(x.shape))

    @property
    def n_words(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n

    def unpack(self) -> torch.Tensor:
        """PlanePack -> int32 tensor of the logical shape (pipeline exit)."""
        vals = unpack_bitplanes(self.planes, self.n_words, signed=self.signed)
        return vals.reshape(self.shape)

    # -- packed-domain transforms (no pack/unpack round trip) ---------------
    def extend_to(self, n_bits: int) -> "PlanePack":
        """Widen to n_bits planes in the packed domain: replicate the sign
        plane (signed) or append zero planes (unsigned)."""
        if n_bits < self.n_bits:
            raise ValueError(f"cannot narrow {self.n_bits} -> {n_bits} planes")
        if n_bits == self.n_bits:
            return self
        extra = n_bits - self.n_bits
        w = self.planes.shape[1]
        if self.signed:
            fill = self.planes[-1:].expand(extra, w)
        else:
            fill = self.planes.new_zeros((extra, w))
        return PlanePack(planes=torch.cat([self.planes, fill], 0),
                         n_bits=n_bits, signed=self.signed, shape=self.shape)

    def align(self, other: "PlanePack") -> Tuple["PlanePack", "PlanePack"]:
        """Widen both operands to the common width, packed-domain only."""
        n = max(self.n_bits, other.n_bits)
        return self.extend_to(n), other.extend_to(n)

    # -- peripheral wiring for the macro-op planner -------------------------
    # zero-access peripheral operations: plane re-weighting (shift),
    # writeback truncation, signedness reinterpretation and row-buffer data
    # movement. None touches the integer codecs or charges the ledger.

    def as_signed(self, signed: bool = True) -> "PlanePack":
        """Reinterpret the same planes under a different signedness."""
        if signed == self.signed:
            return self
        return dataclasses.replace(self, signed=signed)

    def shift_up(self, k: int) -> "PlanePack":
        """Multiply by 2^k: insert k zero planes below the LSB."""
        if k < 0:
            raise ValueError(f"negative plane shift {k}")
        if k == 0:
            return self
        zeros = self.planes.new_zeros((k, self.planes.shape[1]))
        return dataclasses.replace(
            self, planes=torch.cat([zeros, self.planes], 0),
            n_bits=self.n_bits + k)

    def truncate_to(self, n_bits: int) -> "PlanePack":
        """Keep the lowest n_bits planes: arithmetic modulo 2^n_bits."""
        if n_bits > self.n_bits:
            raise ValueError(f"cannot truncate {self.n_bits} -> {n_bits} planes")
        if n_bits == self.n_bits:
            return self
        return dataclasses.replace(self, planes=self.planes[:n_bits],
                                   n_bits=n_bits)

    def shift_elements(self, k: int) -> "PlanePack":
        """Element j <- element j + k (zero fill past the end), per plane:
        a k-bit funnel shift of the packed bitstream."""
        if k < 0:
            raise ValueError(f"negative element shift {k}")
        word, bit = divmod(k, 32)
        p = self.planes
        n, w = p.shape
        if word >= w:
            return dataclasses.replace(self, planes=torch.zeros_like(p))
        if word:
            p = torch.cat([p[:, word:], p.new_zeros((n, word))], 1)
        if bit:
            hi = torch.cat([p[:, 1:], p.new_zeros((n, 1))], 1)
            p = lsr(p, bit) | (hi << (32 - bit))
        return dataclasses.replace(self, planes=p)

    def take_words(self, flat_indices, shape: Tuple[int, ...]) -> "PlanePack":
        """Gather logical elements by flat index into a new pack of `shape`
        (plane-level bit gather + lane repack; never reassembles integers)."""
        idx = torch.as_tensor(flat_indices, dtype=torch.int64,
                              device=self.planes.device).reshape(-1)
        word = idx // 32
        bit = (idx % 32).to(torch.int32)
        bits = (self.planes[:, word] >> bit) & 1          # [n_bits, N]
        pad = (-idx.shape[0]) % 32
        if pad:
            bits = torch.nn.functional.pad(bits, (0, pad))
        return PlanePack(planes=_pack_lanes(bits), n_bits=self.n_bits,
                         signed=self.signed, shape=tuple(shape))

    @classmethod
    def zeros_like(cls, other: "PlanePack") -> "PlanePack":
        """An all-zero pack of the same geometry (the array's zero row)."""
        return dataclasses.replace(other, planes=torch.zeros_like(other.planes))


def mask_to_ints(bitmap: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """[1, W] per-word predicate bitmap -> int32 0/1 tensor of shape."""
    n = 1
    for d in shape:
        n *= int(d)
    w = bitmap.shape[-1]
    bits = unpack_lanes(bitmap.reshape(1, w))[0]
    return bits[:n].reshape(shape)
