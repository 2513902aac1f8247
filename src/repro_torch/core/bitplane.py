"""Bit-plane codecs: integer tensors <-> LSB-first bit-planes / packed planes.

Port of `repro.core.bitplane`. Plane p holds bit p of many words, packed 32
words per lane element. Planes are stored as `torch.int32` tensors holding
the uint32 bit pattern: PyTorch's CPU build has no `~`, `<<` or `>>` for
`torch.uint32`, and int32 `>>` is arithmetic, so bits are always extracted
as `(x >> j) & 1` and a logical right shift masks the sign fill away.

Unlike the reference, which builds an [N, n_bits] bit matrix and lets XLA
fuse it away, the packers here work one plane at a time: in eager PyTorch
the bit matrix of one full-width operand would be several GB.
"""
from __future__ import annotations

import torch

# codec call counters: chained PlanePack pipelines must never re-enter
# these between ops (asserted by the engine tests)
_CODEC_CALLS = {"pack": 0, "unpack": 0}

_WRAP = 1 << 32
_HALF = 1 << 31


def codec_call_counts() -> dict:
    return dict(_CODEC_CALLS)


def reset_codec_call_counts() -> None:
    _CODEC_CALLS["pack"] = 0
    _CODEC_CALLS["unpack"] = 0


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (two's-complement wrap, made explicit)."""
    return (((v + _HALF) % _WRAP) - _HALF).to(torch.int32)


def int_to_bits(x: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Two's-complement LSB-first bit decomposition: [...] -> [..., n_bits]."""
    x = torch.as_tensor(x).to(torch.int32)
    shifts = torch.arange(n_bits, dtype=torch.int32, device=x.device)
    return (x.unsqueeze(-1) >> shifts) & 1


def bits_to_int(bits: torch.Tensor, signed: bool = True) -> torch.Tensor:
    """Inverse of int_to_bits; interprets the MSB as a sign bit if signed.

    Accumulates modulo 2^32 (int32 wrap semantics), exactly as the
    reference does: exact for words of up to 31 value bits (signed) / 32
    bits (wrapped); wider chains keep only their low 32 bits.
    """
    n = bits.shape[-1]
    k = min(n, 32)
    shifts = torch.arange(k, dtype=torch.int64, device=bits.device)
    val = (bits[..., :k].to(torch.int64) << shifts).sum(-1)
    if signed and n < 32:
        val = val - (bits[..., -1].to(torch.int64) << n)
    return wrap_int32(val)


def _pack_lanes(bits: torch.Tensor) -> torch.Tensor:
    """[..., L*32] 0/1 int32 -> [..., L] int32 words (bit j = element j)."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    lanes = bits.reshape(bits.shape[:-1] + (-1, 32))
    # distinct powers of two: the int32 sum IS the bitwise OR (bit 31 wraps
    # to the sign, which is the uint32 pattern held in int32)
    return (lanes << shifts).sum(-1, dtype=torch.int32)


def pack_bitplanes(x: torch.Tensor, n_bits: int) -> torch.Tensor:
    """[words] int -> [n_bits, ceil(words/32)] int32 packed planes.

    Plane p, lane word w, bit position j holds bit p of element 32*w + j.
    """
    _CODEC_CALLS["pack"] += 1
    x = torch.as_tensor(x).reshape(-1).to(torch.int32)
    pad = (-x.shape[0]) % 32
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    planes = torch.empty((n_bits, x.shape[0] // 32), dtype=torch.int32,
                         device=x.device)
    for p in range(n_bits):
        planes[p] = _pack_lanes((x >> p) & 1)
    return planes


def unpack_lanes(planes: torch.Tensor) -> torch.Tensor:
    """[rows, W] int32 packed planes -> [rows, W*32] 0/1 int32 bits."""
    shifts = torch.arange(32, dtype=torch.int32, device=planes.device)
    bits = (planes.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(planes.shape[0], -1)


def unpack_bitplanes(planes: torch.Tensor, n_words: int,
                     signed: bool = True) -> torch.Tensor:
    """[n_bits, W] packed planes -> [n_words] int32 (two's complement)."""
    _CODEC_CALLS["unpack"] += 1
    n = planes.shape[0]
    k = min(n, 32)
    shifts = torch.arange(32, dtype=torch.int32, device=planes.device)
    val = torch.zeros(n_words, dtype=torch.int64, device=planes.device)
    for p in range(k):
        bits = ((planes[p].unsqueeze(-1) >> shifts) & 1).reshape(-1)
        val |= bits[:n_words].to(torch.int64) << p
    if signed and n < 32:
        sign = ((planes[n - 1].unsqueeze(-1) >> shifts) & 1).reshape(-1)
        val = val - (sign[:n_words].to(torch.int64) << n)
    return wrap_int32(val)
