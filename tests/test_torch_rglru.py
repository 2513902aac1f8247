"""Port vs reference: the RG-LRU recurrence.

On the CPU `repro_torch.kernels.ops.rglru_scan` takes the plain version
`rglru_ref`; it is held against the reference's Pallas kernel run in
interpret mode and its jnp oracle at the reference's own tolerance (atol
1e-5), on the reference test's shapes plus T = 1, T = 37 and a nonzero
h0. The CUDA kernel runs only on a card: its case carries the `cuda`
marker and skips here.
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
        tops.rglru_scan(meta, meta, meta, ll.to("meta"))


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
