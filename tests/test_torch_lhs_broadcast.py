"""The matmul's streamed lhs packed straight into broadcast words.

`core/bitplane.py::pack_broadcast_planes` writes the planes of the
[R, K_pad, N] broadcast layout from the [R, K] lhs when N % 32 == 0; they
must equal, to the bit, the planes `pack_bitplanes` makes of the expanded
layout (`macro._expand_lhs`). `macro._contract_with` takes the broadcast
path on N alone, counts which path ran (`macro.lhs_pack_counts`), and a
program's graph replay counts as its eager call did (the stand-in capture
of `_torch_stand_in.py`).
"""
import contextlib

import numpy as np
import pytest
import torch

import _torch_stand_in

from repro_torch.cim import dispatch as tdisp
from repro_torch.cim import macro as tmacro
from repro_torch.cim import planner as tplan
from repro_torch.cim.planepack import PlanePack
from repro_torch.core import bitplane as tb


def _lhs(seed, r, k, signed):
    """[r, k] int8-range words (uint8 range unsigned) holding both ends."""
    lo, hi = (-128, 127) if signed else (0, 255)
    a = np.random.default_rng(seed).integers(lo, hi + 1, (r, k))
    a.flat[0], a.flat[-1] = lo, hi
    if a.size > 2:
        a.flat[1] = hi
    return torch.from_numpy(a.astype(np.int32))


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("n_bits", [1, 4, 8])
@pytest.mark.parametrize("n", [32, 96, 4096])
@pytest.mark.parametrize("k", [1, 5, 32, 100])
@pytest.mark.parametrize("r", [1, 2, 6])
def test_broadcast_planes_equal_expanded(r, k, n, n_bits, signed):
    """Planes, width, signedness and shape equal the expanded pack's, and
    each way bumps the codec's pack count once."""
    a = _lhs(r * 1000 + k * 10 + n_bits, r, k, signed)
    k_pad = 1 << tplan._log2_ceil(k)
    c0 = tb.codec_call_counts()["pack"]
    want = PlanePack.pack(tmacro._expand_lhs(a, k_pad, n), n_bits,
                          signed=signed)
    c1 = tb.codec_call_counts()["pack"]
    got = tmacro._lhs_pack(a, k_pad, n, n_bits, signed)
    c2 = tb.codec_call_counts()["pack"]
    assert (c1 - c0, c2 - c1) == (1, 1)
    assert got.planes.dtype == torch.int32 and got.planes.is_contiguous()
    assert torch.equal(got.planes, want.planes)
    assert (got.n_bits, got.signed, got.shape) == \
        (want.n_bits, want.signed, want.shape)
    assert got.n_words == want.n_words


def test_broadcast_packer_refuses_a_ragged_word():
    with pytest.raises(ValueError, match="N % 32"):
        tb.pack_broadcast_planes(torch.zeros(2, 3, dtype=torch.int32), 4,
                                 48, 8)


@pytest.mark.parametrize("graphed", [False, True])
@pytest.mark.parametrize("n,path", [(31, "expanded"), (33, "expanded"),
                                    (64, "broadcast")])
def test_matmul_path_and_counts_per_call(n, path, graphed):
    """A resident-rhs matmul packs its lhs the broadcast way at N % 32 == 0
    and the expanded way otherwise: each call, eager, captured or replayed,
    moves its path's count by one, the other by none and the codec's packs
    by one (the lhs), with the product exact."""
    m, k = 3, 20
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int32))
    b = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int32))
    want = a.to(torch.int64) @ b.to(torch.int64)
    bp = tmacro.matmul_rhs_pack(b, m, 8)
    tdisp.clear_schedule_cache()
    other = {"broadcast": "expanded", "expanded": "broadcast"}[path]
    with _torch_stand_in.stand_in() if graphed else contextlib.nullcontext():
        for _ in range(4):
            c0, p0 = tmacro.lhs_pack_counts(), tb.codec_call_counts()["pack"]
            got = tmacro.matmul(a, b_pack=bp)
            c1, p1 = tmacro.lhs_pack_counts(), tb.codec_call_counts()["pack"]
            assert torch.equal(got.to(torch.int64), want)
            assert c1[path] - c0[path] == 1 and c1[other] == c0[other]
            assert p1 - p0 == 1
    g = tdisp.graph_stats()
    assert (g["captured"], g["replays"]) == ((1, 3) if graphed else (0, 0))
    tdisp.clear_schedule_cache()
    assert tmacro.lhs_pack_counts() == {"broadcast": 0, "expanded": 0}

