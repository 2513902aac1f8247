"""Port vs reference: the sLSTM recurrence.

On the CPU `repro_torch.kernels.ops.slstm_scan` takes the plain version
`slstm_ref`; it is held against the reference's Pallas kernel
`repro.kernels.slstm.slstm_scan` run in interpret mode at the reference's
own tolerance (atol 1e-5), on the reference test's shapes plus T = 1,
B = 5 (the reference pads the batch to its block) and a nonzero initial
state. The CUDA kernels run only on a card: their cases carry the `cuda`
marker and skip here. The routing rule between the two kernels is a pure
function of dtype and shape, checked here on meta and CPU tensors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.slstm import slstm_scan as r_slstm_scan
from repro_torch import kernel_build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import slstm as tslstm

#: the reference's kernel-vs-oracle tolerance (tests/test_kernels.py)
TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """The plain version on one intra-op thread (see
    tests/test_torch_rglru.py: on a virtual machine with AVX-512 the first
    multithreaded `torch.exp` of a fresh process was seen to be off by
    about 1e-4)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, t, d, random_state, r_scale=0.2):
    """wx, R (scaled as the reference test's 0.2 unless given), b, and the
    initial state: the reference's default (h = c = m = 0, n = 1) or random
    with n > 0."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    wx = rng.normal(size=(b, t, 4, d)).astype(f32)
    r = (rng.normal(size=(d, 4, d)) * r_scale).astype(f32)
    bg = (rng.normal(size=(4, d)) * 0.1).astype(f32)
    if random_state:
        h0, c0, m0 = (rng.normal(size=(b, d)).astype(f32) for _ in range(3))
        n0 = rng.uniform(0.5, 2.0, size=(b, d)).astype(f32)
    else:
        h0, c0, m0 = (np.zeros((b, d), f32) for _ in range(3))
        n0 = np.ones((b, d), f32)
    return wx, r, bg, h0, c0, n0, m0


@pytest.mark.parametrize("b,t,d,random_state", [
    (3, 32, 64, False), (5, 64, 128, False), (2, 48, 256, False),
    (5, 1, 64, False), (5, 1, 128, True), (3, 37, 96, True)])
def test_slstm_scan_matches_pallas_interpret(b, t, d, random_state):
    args = _inputs(b * 1000 + t, b, t, d, random_state)
    ty, tstate = tops.slstm_scan(*(torch.from_numpy(a) for a in args))
    assert ty.shape == (b, t, d) and ty.dtype == torch.float32
    ry, rstate = r_slstm_scan(*(jnp.asarray(a) for a in args), block_b=4,
                              interpret=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), **TOL)
    for got, want in zip(tstate, rstate):
        assert got.shape == (b, d) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_slstm_ref_dtypes():
    """R and b in bfloat16 (the full-width path's compute cast) are upcast:
    the result equals the float32 run on the same rounded values. A
    bfloat16 wx gives y in bfloat16 and the state in float32; a float64 wx
    computes in float64 (the card's exact value for wide D)."""
    args = [torch.from_numpy(a) for a in _inputs(9, 2, 20, 64, True)]
    wx, r, bg = args[:3]
    r16, b16 = r.to(torch.bfloat16), bg.to(torch.bfloat16)
    y16, s16 = tref.slstm_ref(wx, r16, b16, *args[3:])
    y32, s32 = tref.slstm_ref(wx, r16.float(), b16.float(), *args[3:])
    assert torch.equal(y16, y32)
    for a, b_ in zip(s16, s32):
        assert torch.equal(a, b_)
    yb, sb = tref.slstm_ref(wx.to(torch.bfloat16), r, bg, *args[3:])
    assert yb.dtype == torch.bfloat16
    assert all(s.dtype == torch.float32 for s in sb)
    yw, _ = tref.slstm_ref(wx.to(torch.bfloat16).float(), r, bg, *args[3:])
    assert torch.equal(yb, yw.to(torch.bfloat16))
    y64, s64 = tref.slstm_ref(*(a.double() for a in args))
    assert y64.dtype == torch.float64
    assert all(s.dtype == torch.float64 for s in s64)
    y32, _ = tref.slstm_ref(*args)
    np.testing.assert_allclose(y64.numpy(), y32.numpy(), **TOL)


def test_kernel_wrapper_takes_only_cuda_tensors():
    args = [torch.from_numpy(a) for a in _inputs(1, 1, 2, 8, False)]
    with pytest.raises(ValueError, match="CUDA"):
        tslstm.slstm(*args)
    with pytest.raises(ValueError, match="CUDA"):
        tslstm.slstm(*(a.to("meta") for a in args))
    # meta (the dry run) takes the plain version by the named rule
    y, state = tops.slstm_scan(*(a.to("meta") for a in args))
    assert y.device.type == "meta" and len(state) == 4


def test_kernel_source_and_build_location():
    assert tslstm.SOURCE.is_file()
    path = kernel_build.library_path(tslstm.SOURCE)
    assert path.name.startswith("slstm_") and path.suffix == ".so"
    assert path.parent == kernel_build.BUILD_DIR
    src = tslstm.SOURCE.read_text()
    assert "src/repro/kernels/slstm.py::_slstm_kernel" in src
    assert 'extern "C" int slstm_launch' in src


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """R drawn as the model draws it, N(0, 1/D): with N(0, 0.04) at
    D >= 768 the recurrence is chaotic and two float32 summation orders
    part within a few dozen steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for (b, t, d), wx_dtype, r_dtype in (
            ((2, 1, 768), torch.float32, torch.bfloat16),
            ((3, 37, 1500), torch.float32, torch.float32),
            ((2, 48, 256), torch.bfloat16, torch.bfloat16)):
        args = [torch.from_numpy(a).to(dev)
                for a in _inputs(3, b, t, d, True, r_scale=d ** -0.5)]
        wx = args[0].to(wx_dtype)
        r, bg = args[1].to(r_dtype), args[2].to(r_dtype)
        y, state = tops.slstm_scan(wx, r, bg, *args[3:])
        yp, statep = tref.slstm_ref(wx, r, bg, *args[3:])
        for got, want in zip(state, statep):
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        dy = (y.float() - yp.float()).abs()
        assert bool((dy <= 2.0 ** -7 * yp.float().abs() + 1e-5).all())


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("b,d,wx_dtype,r_dtype,want", [
    (2, 768, F32, F32, "sm90"), (2, 768, F32, BF16, "sm90"),
    (1, 768, F32, BF16, "sm90"), (4, 768, BF16, BF16, "sm90"),
    (32, 768, F32, F32, "sm90"), (33, 768, F32, BF16, "rows"),
    (3, 64, F32, F32, "sm90"), (5, 128, BF16, BF16, "sm90"),
    (3, 1500, F32, BF16, "sm90"), (3, 1500, F32, F32, "rows"),
    (2, 3000, F32, BF16, "rows"), (1, 7000, F32, F32, "rows"),
    (1, 1152, F32, F32, "sm90"), (1, 1160, F32, F32, "rows"),
    (1, 1536, F32, BF16, "sm90"), (1, 1540, F32, BF16, "rows")])
def test_route(b, d, wx_dtype, r_dtype, want):
    """xlstm-125m's D = 768 takes the persistent grid with R in float32 or
    bfloat16, up to 32 rows; slices that do not fit 227 KB of shared memory
    and wider batches take the one-block-per-row kernel. Meta and CPU
    tensors of one dtype and shape route alike."""
    for device in ("meta", "cpu"):
        wx = torch.empty((b, 2, 4, d), dtype=wx_dtype, device=device)
        r = torch.empty((d, 4, d), dtype=r_dtype, device=device)
        assert tslstm.route(wx, r) == want


@pytest.mark.parametrize("b,d,r_dtype,want", [
    (2, 768, BF16, (8, 2, 768, 772, 8 * 4 * 772 * 2 + 2 * 768 * 4)),
    (1, 768, F32, (8, 1, 768, 772, 8 * 4 * 772 * 4 + 768 * 4)),
    (3, 1500, BF16, (16, 4, 1500, 1504, 16 * 4 * 1504 * 2 + 4 * 1500 * 4)),
    (5, 63, F32, (1, 4, 64, 68, 4 * 68 * 4 + 8 * 64 * 4))])
def test_grid_geometry(b, d, r_dtype, want):
    """The geometry the wrapper passes to the kernel: channels per block,
    batch tile (1, 2 or 4 rows), h's and R's row strides (D rounded up to 4,
    plus 4 for R) and shared bytes per block (R's slice in R's dtype, then
    h for B rounded up to the tile in float32); at most 96 blocks."""
    g = tslstm.grid_geometry(b, d, r_dtype)
    assert tuple(g) == want
    assert -(-d // g.channels) <= tslstm.GRID_BLOCKS
    assert tslstm.grid_geometry(b, d, r_dtype, blocks=128).channels == \
        -(-d // 128)


def test_sm90_source_and_build_location():
    assert tslstm.SOURCE_SM90.is_file()
    path = kernel_build.library_path(tslstm.SOURCE_SM90)
    assert path.name.startswith("slstm_sm90_") and path.suffix == ".so"
    assert path.parent == kernel_build.BUILD_DIR
    src = tslstm.SOURCE_SM90.read_text()
    assert "src/repro/kernels/slstm.py::_slstm_kernel" in src
    assert 'extern "C" int slstm_sm90_launch' in src
    assert "cudaLaunchCooperativeKernel" in src
    for lib in ("cublas", "cudnn", "matmul"):
        assert lib not in src.lower()


@pytest.mark.parametrize("name", ["slstm_sm90", "slstm_rows", "slstm"])
def test_each_wrapper_takes_only_cuda_tensors(name):
    args = [torch.from_numpy(a) for a in _inputs(1, 1, 2, 8, False)]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(tslstm, name)(*args)


def test_cpu_path_counts_no_launch():
    """`launches()` sums the two kernels' own counts; the plain version on
    CPU tensors adds to neither."""
    before = (tslstm.slstm_sm90.launches, tslstm.slstm_rows.launches)
    assert tslstm.launches() == sum(before)
    tops.slstm_scan(*(torch.from_numpy(a)
                      for a in _inputs(2, 2, 3, 16, True)))
    assert (tslstm.slstm_sm90.launches, tslstm.slstm_rows.launches) == before


@pytest.mark.cuda
def test_sm90_kernel_matches_plain_version():
    """The persistent-grid kernel alone, by its launch count, at the decode
    shape, a long prompt and several rows sharing each block's slice of R
    across barriers; tolerances as `test_cuda_kernel_matches_plain_version`
    (1e-4 past T = 64, as `chip_smoke.py::phase_slstm`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for b, t, d in ((2, 1, 768), (1, 512, 768), (4, 64, 768)):
        args = [torch.from_numpy(a).to(dev)
                for a in _inputs(4, b, t, d, True, r_scale=d ** -0.5)]
        r, bg = args[1].to(torch.bfloat16), args[2].to(torch.bfloat16)
        assert tslstm.route(args[0], r) == "sm90"
        before = tslstm.slstm_sm90.launches
        y, state = tops.slstm_scan(args[0], r, bg, *args[3:])
        assert tslstm.slstm_sm90.launches == before + 1
        yp, statep = tref.slstm_ref(args[0], r, bg, *args[3:])
        atol = 1e-5 if t <= 64 else 1e-4
        for got, want in zip([*state, y], [*statep, yp]):
            torch.testing.assert_close(got, want, atol=atol, rtol=0)
