"""Port vs reference: the RG-LRU recurrence.

On the CPU `repro_torch.kernels.ops.rglru_scan` takes the plain version
`rglru_ref`; it is held against the reference's Pallas kernel run in
interpret mode and its jnp oracle at the reference's own tolerance (atol
1e-5), on the reference test's shapes plus T = 1, T = 37 and a nonzero
h0. The CUDA kernels (one thread per channel, `csrc/rglru.cu`; TMA channel
tiles, `csrc/rglru_sm90.cu`) run only on a card: their cases carry the
`cuda` marker and skip here. What surrounds them is checked here: the
routing rule, the TMA kernel's geometry, and the wrappers' refusals.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch import kernel_build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru as trglru

#: the reference's kernel-vs-oracle tolerance (tests/test_kernels.py)
TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """The plain version on one intra-op thread. On a virtual machine with
    AVX-512, the first multithreaded `torch.exp` of a fresh process was
    seen to return values off by about 1e-4 in some processes (later calls
    exact; never on one thread), which the atol-1e-5 comparisons here would
    report. Threading is not what these tests check."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, t, d, with_h0):
    rng = np.random.default_rng(seed)
    x, r, i = (rng.normal(size=(b, t, d)).astype(np.float32) for _ in range(3))
    ll = rng.normal(size=(d,)).astype(np.float32)
    h0 = rng.normal(size=(b, d)).astype(np.float32) if with_h0 else None
    return x, r, i, ll, h0


def _torch(a):
    return None if a is None else torch.from_numpy(a)


def _jax(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("b,t,d,with_h0", [
    (1, 128, 128, False), (2, 256, 256, False), (3, 128, 384, False),
    (2, 1, 128, True), (1, 37, 128, True), (2, 256, 128, True)])
def test_rglru_scan_matches_pallas_interpret_and_oracle(b, t, d, with_h0):
    x, r, i, ll, h0 = _inputs(b * 1000 + t, b, t, d, with_h0)
    ty, th = tops.rglru_scan(*map(_torch, (x, r, i, ll)), h0=_torch(h0))
    assert ty.shape == (b, t, d) and ty.dtype == torch.float32
    assert th.shape == (b, d) and th.dtype == torch.float32
    py, ph = rops.rglru_scan(*map(_jax, (x, r, i, ll)), h0=_jax(h0),
                             use_pallas=True, interpret=True)
    ey, eh = rref.rglru_ref(*map(_jax, (x, r, i, ll)), h0=_jax(h0))
    for want_y, want_h in ((py, ph), (ey, eh)):
        np.testing.assert_allclose(ty.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(th.numpy(), np.asarray(want_h), **TOL)


def test_rglru_scan_bf16_keeps_y_dtype_and_f32_state():
    """bf16 gates: y comes back in bf16, h_T in float32; both compute in
    float32 from the same bf16 values, so h_T agrees at atol 1e-5 and y
    within one bf16 rounding."""
    x, r, i, ll, h0 = _inputs(7, 2, 37, 128, True)
    tx, tr, ti = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, r, i))
    ty, th = tops.rglru_scan(tx, tr, ti, torch.from_numpy(ll),
                             h0=torch.from_numpy(h0))
    assert ty.dtype == torch.bfloat16 and th.dtype == torch.float32
    jx, jr, ji = (jnp.asarray(a, jnp.bfloat16) for a in (x, r, i))
    ey, eh = rref.rglru_ref(jx, jr, ji, jnp.asarray(ll), h0=jnp.asarray(h0))
    np.testing.assert_allclose(th.numpy(), np.asarray(eh), **TOL)
    want = np.asarray(ey, np.float32)
    dy = np.abs(ty.float().numpy() - want)
    assert (dy <= 2.0 ** -7 * np.abs(want) + 1e-5).all(), dy.max()


def test_softplus_has_no_threshold():
    """jax.nn.softplus is logaddexp(x, 0); torch's F.softplus returns x
    itself above 20. The port's plain version follows jax."""
    x = torch.tensor([-30.0, -1.0, 0.0, 3.0, 20.5, 25.0], dtype=torch.float64)
    got = tref.softplus(x)
    want = np.logaddexp(x.numpy(), 0.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=0)
    assert float(got[-1]) > 25.0
    assert float(torch.nn.functional.softplus(x)[-1]) == 25.0


def test_kernel_wrapper_takes_only_cuda_tensors():
    x = torch.zeros((1, 2, 8))
    ll = torch.zeros((8,))
    with pytest.raises(ValueError, match="CUDA"):
        trglru.rglru(x, x, x, ll)
    meta = torch.zeros((1, 2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        trglru.rglru(meta, meta, meta, ll.to("meta"))
    # meta (the dry run) takes the plain version by the named rule
    y, h = tops.rglru_scan(meta, meta, meta, ll.to("meta"))
    assert y.device.type == h.device.type == "meta" and y.shape == (1, 2, 8)


def test_kernel_source_and_build_location():
    assert trglru.SOURCE.is_file()
    path = kernel_build.library_path(trglru.SOURCE)
    assert path.name.startswith("rglru_") and path.suffix == ".so"
    assert path.parent == kernel_build.BUILD_DIR
    assert path.parent.name == "repro_torch_kernels"


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for (b, t, d), dtype in (((2, 1, 4096), torch.bfloat16),
                             ((3, 37, 1000), torch.float32)):
        x, r, i, ll, h0 = (None if a is None else torch.from_numpy(a).to(dev)
                           for a in _inputs(3, b, t, d, True))
        x, r, i = (a.to(dtype) for a in (x, r, i))
        y, h = tops.rglru_scan(x, r, i, ll, h0=h0)
        yp, hp = tref.rglru_ref(x, r, i, ll, h0=h0)
        torch.testing.assert_close(h, hp, atol=1e-5, rtol=0)
        dy = (y.float() - yp.float()).abs()
        assert bool((dy <= 2.0 ** -7 * yp.float().abs() + 1e-5).all())


# --- the TMA channel-tile kernel (csrc/rglru_sm90.cu) and the routing rule

def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("shape,dtype,want,channels", [
    ((2, 1, 4096), torch.bfloat16, "rows", None),      # decode
    ((2, 1, 4096), torch.float32, "rows", None),
    ((1, 4, 4096), torch.bfloat16, "rows", None),      # below SM90_MIN_T
    ((2, 7, 4096), torch.bfloat16, "rows", None),
    ((1, 8, 4096), torch.bfloat16, "sm90", 32),        # CiM serve prefill
    ((1, 2040, 4096), torch.bfloat16, "sm90", 32),     # float prefill
    ((1, 2048, 4096), torch.float32, "sm90", 32),
    ((2, 2048, 4096), torch.bfloat16, "sm90", 32),
    ((3, 1000, 1000), torch.bfloat16, "sm90", 16),     # ragged T and D
    ((1, 37, 1000), torch.float32, "sm90", 16),
    ((1, 64, 1024), torch.bfloat16, "sm90", 16),       # 32 blocks at C=32
    ((4, 64, 1024), torch.bfloat16, "sm90", 32),       # 128 blocks at C=32
    ((2, 64, 1001), torch.float32, "rows", None),      # row of 4004 bytes
    ((2, 64, 1004), torch.float32, "sm90", 16),        # row of 4016 bytes
    ((2, 64, 1004), torch.bfloat16, "rows", None),     # row of 2008 bytes
    ((2, 64, 512), torch.float64, "rows", None),
])
def test_route_and_tile_geometry(shape, dtype, want, channels):
    """`route` is a pure function of dtype, shape, strides and alignment;
    `tile_geometry` alone sizes the sm90 kernel's grid: B * ceil(D / C)
    blocks, C = 32 where that still covers FILL_BLOCKS and 16 where it
    cannot fill the card, the last block of a ragged D masked, and shared
    memory within a block's limit."""
    x = _meta(shape, dtype)
    assert trglru.route(x) == want
    assert trglru.route(x, x, x) == want
    if want == "rows":
        return
    b, t, d = shape
    g = trglru.tile_geometry(b, t, d, dtype)
    assert g.channels == channels
    assert g.blocks == b * -(-d // channels)
    assert (channels == 32) == (b * -(-d // 32) >= trglru.FILL_BLOCKS)
    assert g.warps % 4 == 0
    assert trglru.gate_warps(g.warps) >= 1
    # 24 warps where a block has an SM to itself, 12 where two share one
    two_fit = 2 * g.smem <= trglru.SM_SMEM
    assert g.warps == (12 if g.blocks > trglru.SMS and two_fit else 24)
    assert (g.channels * x.element_size()) % 16 == 0
    assert g.smem <= trglru.SMEM_MAX
    # T never changes the geometry: the last time tile is masked
    assert trglru.tile_geometry(b, 1, d, dtype) == g
    ragged = d % g.channels
    assert (d - ragged) // g.channels + (1 if ragged else 0) == g.blocks // b


def test_route_refuses_what_tma_cannot_address():
    """Contiguous, 16-byte-aligned data only: a view two bytes into its
    storage, or a transposed one, goes to the rows kernel (which raises on
    the non-contiguous one, as every kernel wrapper here does)."""
    base = torch.zeros(1 * 64 * 512 + 8, dtype=torch.bfloat16)
    ok = base[:64 * 512].view(1, 64, 512)
    off = base[1:1 + 64 * 512].view(1, 64, 512)
    assert trglru.route(ok) == "sm90" and trglru.sm90_takes(ok)
    assert trglru.route(off) == "rows" and not trglru.sm90_takes(off)
    assert trglru.route(ok, ok, off) == "rows"
    tr = torch.zeros((1, 512, 64), dtype=torch.bfloat16).transpose(1, 2)
    assert trglru.route(tr) == "rows"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_geometry_sweep_fits_shared_memory(dtype):
    """Every geometry `chip_smoke.py` sweeps (C 16 and 32, ring depth 2-4,
    8-32 warps) fits a block, and the default bf16 geometry leaves room
    for two blocks an SM (B * ceil(D / C) > 132 at two batch rows)."""
    for c in (16, 32):
        for s in (2, 3, 4):
            for w in (8, 12, 16, 24, 32):
                g = trglru.tile_geometry(2, 2048, 4096, dtype, channels=c,
                                         stages=s, warps=w)
                assert g.smem <= trglru.SMEM_MAX, g
                assert g.smem > s * 3 * trglru.TILE_T * c * (
                    4 if dtype == torch.float32 else 2)
    if dtype == torch.bfloat16:
        g = trglru.tile_geometry(2, 2048, 4096, dtype)
        assert 2 * g.smem <= 228 * 1024, g


@pytest.mark.parametrize("case", ["cpu", "dtype", "contiguity", "shape"])
def test_sm90_wrapper_refuses_with_plain_version_named(case):
    x = torch.zeros((1, 32, 64))
    ll = torch.zeros((64,))
    args = [x, x, x, ll]
    match = {"cpu": "CUDA", "dtype": "float32 or bfloat16",
             "contiguity": "contiguous", "shape": "shape"}[case]
    if case == "dtype":
        args[:3] = [x.double()] * 3
    elif case == "contiguity":
        args[1] = torch.zeros((1, 64, 32)).transpose(1, 2)
    elif case == "shape":
        args[2] = torch.zeros((1, 32, 65))
    before = trglru.launches()
    with pytest.raises(ValueError, match=match) as err:
        trglru.rglru_sm90(*args)
    if case != "shape":
        assert "plain version" in str(err.value)
        assert "rglru_ref" in str(err.value)
    assert trglru.launches() == before


def test_launch_counts_are_per_kernel_and_summed():
    saved = (trglru.rglru_sm90.launches, trglru.rglru_rows.launches)
    try:
        trglru.rglru_sm90.launches, trglru.rglru_rows.launches = 3, 4
        assert trglru.launches() == 7
    finally:
        trglru.rglru_sm90.launches, trglru.rglru_rows.launches = saved


def test_sm90_source_note_and_build_location():
    assert trglru.SOURCE_SM90.is_file()
    note = trglru.SOURCE_SM90.read_text()
    assert "src/repro/kernels/rglru.py::_rglru_kernel" in note
    assert "What bounds it: bytes" in note
    assert "rglru_ref" in note
    path = kernel_build.library_path(trglru.SOURCE_SM90)
    assert path.name.startswith("rglru_sm90_") and path.suffix == ".so"
    assert path.parent == kernel_build.BUILD_DIR
    root = kernel_build.BUILD_DIR.parents[1]
    ignored = (root / ".gitignore").read_text().split()
    assert "build/" in ignored


@pytest.mark.cuda
def test_cuda_routed_kernels_match_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for (b, t, d), dtype in (((2, 1, 4096), torch.bfloat16),
                             ((1, 2040, 4096), torch.bfloat16),
                             ((2, 130, 1000), torch.float32)):
        x, r, i, ll, h0 = (None if a is None else torch.from_numpy(a).to(dev)
                           for a in _inputs(5, b, t, d, True))
        x, r, i = (a.to(dtype) for a in (x, r, i))
        want = trglru.route(x, r, i)
        before = trglru.rglru_sm90.launches
        y, h = tops.rglru_scan(x, r, i, ll, h0=h0)
        assert trglru.rglru_sm90.launches - before == int(want == "sm90")
        yp, hp = tref.rglru_ref(x, r, i, ll, h0=h0)
        torch.testing.assert_close(h, hp, atol=1e-5, rtol=0)
        dy = (y.float() - yp.float()).abs()
        assert bool((dy <= 2.0 ** -7 * yp.float().abs() + 1e-5).all())
        ya, ha = trglru.rglru_sm90(x, r, i, ll, h0=h0)
        yb, hb = trglru.rglru_rows(x, r, i, ll, h0=h0)
        assert torch.equal(ya, yb) and torch.equal(ha, hb)


@pytest.mark.parametrize("warps,gates", [(4, 2), (8, 5), (12, 8), (16, 11),
                                         (24, 17), (32, 23)])
def test_gate_warps_leave_the_scan_warps_sub_partition(warps, gates):
    """Warp w runs on sub-partition w % 4: the producer is warp 0, the
    scan warp 1; the other warps of sub-partition 1 leave, the rest are
    gate warps, numbered 0, 1, ... as the kernel's gate_rank numbers them."""
    assert trglru.gate_warps(warps) == gates
    ranks = [w for w in range(2, warps) if w % 4 != 1]
    assert len(ranks) == gates
    assert [(w - 2) - (w - 2) // 4 for w in ranks] == list(range(gates))
