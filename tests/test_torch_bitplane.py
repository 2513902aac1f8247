"""Port vs reference: bit-plane codecs and PlanePack peripherals.

Same numpy inputs (seeded) through `repro` and `repro_torch`; planes are
compared bit for bit as uint32 views (the port holds them in int32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cim import planepack as rpp
from repro.core import bitplane as rb
from repro_torch.cim import planepack as tpp
from repro_torch.core import bitplane as tb


def _u32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).view(np.uint32)


def _ints(seed, n, bits, signed):
    """n random words of `bits` bits as int32 (unsigned 32-bit words wrap
    to their int32 bit pattern)."""
    lo, hi = (-2 ** (bits - 1), 2 ** (bits - 1)) if signed else (0, 2 ** bits)
    x = np.random.default_rng(seed).integers(lo, hi, n, dtype=np.int64)
    return x.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("n", [1, 33, 100])
def test_codecs_match_reference(bits, signed, n):
    x = _ints(bits * 1000 + n, n, bits, signed)
    rb.reset_codec_call_counts()
    tb.reset_codec_call_counts()
    r = rb.pack_bitplanes(jnp.asarray(x), bits)
    t = tb.pack_bitplanes(torch.from_numpy(x), bits)
    np.testing.assert_array_equal(_u32(t), _u32(r))
    ru = np.asarray(rb.unpack_bitplanes(r, n, signed=signed))
    tu = tb.unpack_bitplanes(t, n, signed=signed).numpy()
    np.testing.assert_array_equal(tu, ru)
    assert tb.codec_call_counts() == rb.codec_call_counts() \
        == {"pack": 1, "unpack": 1}
    rbits = np.asarray(rb.int_to_bits(jnp.asarray(x), bits))
    tbits = tb.int_to_bits(torch.from_numpy(x), bits).numpy()
    np.testing.assert_array_equal(tbits, rbits)
    np.testing.assert_array_equal(
        tb.bits_to_int(torch.from_numpy(tbits), signed=signed).numpy(),
        np.asarray(rb.bits_to_int(jnp.asarray(rbits), signed=signed)))


def _packs(seed, shape, bits, signed=True):
    x = _ints(seed, int(np.prod(shape)), bits, signed).reshape(shape)
    return (rpp.PlanePack.pack(jnp.asarray(x), bits, signed=signed),
            tpp.PlanePack.pack(torch.from_numpy(x), bits, signed=signed))


def _same(r, t):
    assert (t.n_bits, t.signed, tuple(t.shape)) == \
        (r.n_bits, r.signed, tuple(r.shape))
    np.testing.assert_array_equal(_u32(t.planes), _u32(r.planes))
    np.testing.assert_array_equal(t.unpack().numpy(), np.asarray(r.unpack()))


@pytest.mark.parametrize("signed", [True, False])
def test_planepack_widening_and_plane_shifts(signed):
    r, t = _packs(1, (5, 13), 8, signed)
    _same(r, t)
    _same(r.extend_to(13), t.extend_to(13))
    r2, t2 = _packs(2, (5, 13), 11, signed)
    for (ra, ta) in zip(r.align(r2), t.align(t2)):
        _same(ra, ta)
    _same(r.shift_up(3), t.shift_up(3))
    _same(r.truncate_to(5), t.truncate_to(5))
    _same(r.as_signed(not signed), t.as_signed(not signed))
    _same(rpp.PlanePack.zeros_like(r), tpp.PlanePack.zeros_like(t))


@pytest.mark.parametrize("k", [0, 1, 7, 31, 32, 33, 70, 500])
def test_shift_elements_matches_reference(k):
    r, t = _packs(3, (3, 41), 16)
    _same(r.shift_elements(k), t.shift_elements(k))


def test_take_words_and_mask_to_ints_match_reference():
    r, t = _packs(4, (6, 19), 12)
    idx = np.random.default_rng(5).integers(0, 6 * 19, 37)
    _same(r.take_words(idx, (37,)), t.take_words(torch.from_numpy(idx), (37,)))
    bm = np.random.default_rng(6).integers(0, 2 ** 32, (1, 3),
                                           dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        tpp.mask_to_ints(torch.from_numpy(bm.view(np.int32)), (7, 11)).numpy(),
        np.asarray(rpp.mask_to_ints(jnp.asarray(bm), (7, 11))))
