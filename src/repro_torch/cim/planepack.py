"""PlanePack: packed bit-plane tensor — the CiM engine's working format.

Port of `repro.cim.planepack`: the pack, its zero-access peripherals and
the SECDED codec of the fault layer. It carries the packed plane
stack — an int32 tensor [n_bits, W] holding uint32 bit patterns, plane p =
bit p of 32 words per lane element — plus the metadata (n_bits,
signedness, logical shape) needed to re-assemble integers, so chained CiM
ops stay packed between calls.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

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


# ---------------------------------------------------------------------------
# SECDED ECC across the plane index
# ---------------------------------------------------------------------------
#
# One logical element occupies a column: bit j of lane word w across the
# n_bits plane rows. A Hamming code across the plane index protects every
# element independently, one parity plane per Hamming check bit plus one
# overall-parity plane, all XORs over plane rows. Per column any single bit
# flip is corrected, any double flip detected (never miscorrected); three
# or more may alias a valid syndrome, the classic SECDED bound.
#
# The reference runs this numpy-eager on host copies. Here the same plane
# math runs in torch on the planes' own device (a full-width pin is tens of
# MB of planes: a host copy per verify would dominate a decode step), and
# only the two popcounts come back to the host.


def _hamming_data_positions(m: int) -> List[int]:
    """Hamming codeword positions of the m data planes: the first m
    positive integers that are not powers of two (powers of two are the
    check-bit positions)."""
    pos, p = [], 3
    while len(pos) < m:
        if p & (p - 1):
            pos.append(p)
        p += 1
    return pos


def ecc_plane_count(n_bits: int) -> int:
    """Parity planes protecting `n_bits` data planes: r Hamming check
    planes (2^r >= n_bits + r + 1) plus the overall-parity plane."""
    if n_bits < 1:
        raise ValueError(f"cannot protect {n_bits} planes")
    r = 0
    while (1 << r) < n_bits + r + 1:
        r += 1
    return r + 1


def _xor_rows(rows: List[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros_like(like)
    for row in rows:
        acc = acc ^ row
    return acc


def popcount_total(mask: torch.Tensor) -> torch.Tensor:
    """Set bits of an int32 tensor holding uint32 patterns, summed: a 0-dim
    int64 tensor on the mask's device (SWAR in int64, so bit 31 is an
    ordinary bit)."""
    x = mask.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return x.sum()


def ecc_encode(planes: torch.Tensor) -> torch.Tensor:
    """int32[m, W] data planes -> int32[r+1, W] parity planes (r Hamming
    check planes, then the overall parity plane), on the planes' device."""
    data = planes
    m = data.shape[0]
    r = ecc_plane_count(m) - 1
    pos = _hamming_data_positions(m)
    checks = [_xor_rows([data[i] for i, p in enumerate(pos) if (p >> k) & 1],
                        data[0]) for k in range(r)]
    overall = _xor_rows([data[i] for i in range(m)] + checks, data[0])
    return torch.stack(checks + [overall])


def syndrome_is(syn: List[torch.Tensor], p: int,
                like: torch.Tensor) -> torch.Tensor:
    """Lane mask of the columns whose syndrome (planes `syn`, one per
    Hamming check bit) equals the codeword position `p`."""
    acc = torch.full_like(like, -1)
    for k, s in enumerate(syn):
        acc = acc & (s if (p >> k) & 1 else ~s)
    return acc


def ecc_check_correct(planes: torch.Tensor, parity: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """Verify (and repair) a protected plane stack.

    Returns (data, parity, corrected, uncorrected): the repaired stacks
    plus per-bit counts. `corrected` single-bit errors were repaired in
    place (data, check or overall planes alike); `uncorrected` bits were
    detected but cannot be repaired (even total parity with a nonzero
    syndrome: a double error in one column). The caller treats any nonzero
    `uncorrected` as data loss. Without a correction the inputs come back
    as they were (no copy)."""
    data, par = planes, parity
    m = data.shape[0]
    r = par.shape[0] - 1
    pos = _hamming_data_positions(m)
    like = data[0]

    syn = [_xor_rows([par[k]] + [data[i] for i, p in enumerate(pos)
                                 if (p >> k) & 1], like) for k in range(r)]
    overall = _xor_rows([data[i] for i in range(m)]
                        + [par[k] for k in range(r + 1)], like)
    any_syn = torch.zeros_like(like)
    for s in syn:
        any_syn = any_syn | s

    data_fix = [syndrome_is(syn, p, like) & overall for p in pos]
    check_fix = [syndrome_is(syn, 1 << k, like) & overall for k in range(r)]
    overall_fix = syndrome_is(syn, 0, like) & overall
    fixed = torch.zeros_like(like)
    for fix in data_fix + check_fix + [overall_fix]:
        fixed = fixed | fix
    # even parity + nonzero syndrome: double error (detected, not fixable);
    # odd parity pointing outside every valid position: 3+ flips, ditto
    uncorrectable = (any_syn & ~overall) | (overall & ~fixed)
    # a column has one syndrome, so the fix masks are disjoint: their
    # union's popcount is the sum of theirs
    counts = torch.stack([popcount_total(fixed),
                          popcount_total(uncorrectable)]).tolist()
    corrected, uncorrected = int(counts[0]), int(counts[1])
    if corrected:
        data = data ^ torch.stack(data_fix)
        par = par ^ torch.stack(check_fix + [overall_fix])
    return data, par, corrected, uncorrected
