"""Port vs reference: flash attention, its backward and the attention layer.

On the CPU `repro_torch.kernels.ops.attention` takes the plain version
`mha_ref` forward and the ported blockwise FlashAttention-2 backward. The
plain version's o is held against the reference's Pallas kernel run in
interpret mode and its `ref.mha_ref`, and its lse against the lse of the
reference's blockwise forward, at the reference test's tolerances (2e-6
float32, 2e-2 bfloat16) on its four shapes. Gradients are held against
`jax.grad` of the reference's `blockwise_attention` and `mha_ref`, plus a
float64 `gradcheck`. `gqa_apply` (with and without flash) and
`gqa_prefill` are held against the reference at T = 16 (dense) and
T = 1024 (blockwise). The routing rule that picks the wgmma/TMA kernel
or the SIMT kernel is a pure function, checked here on CPU tensors. The
CUDA kernels run only on a card: their case carries the `cuda` marker and
skips here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.models import attention as r_attn
from repro.models import blockwise_attention as r_bw
from repro_torch import kernel_build
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as t_attn
from repro_torch.models import blockwise_attention as t_bw

SHAPES = [(1, 128, 128, 4, 4, 64), (2, 128, 128, 4, 2, 64),
          (1, 256, 256, 8, 1, 64), (1, 64, 192, 4, 2, 32)]
#: the reference's kernel-vs-oracle tolerances (tests/test_kernels.py:113)
TOL = {"float32": 2e-6, "bfloat16": 2e-2}
#: gradients of float32 attention in two frameworks: sums of up to 256
#: products taken in other orders, then through the softmax backward
GRAD_TOL = dict(atol=2e-5, rtol=2e-5)


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


def _qkv(shape, seed=0):
    b, tq, tk, hq, hkv, d = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, tq, hq, d)).astype(np.float32),
            rng.normal(size=(b, tk, hkv, d)).astype(np.float32),
            rng.normal(size=(b, tk, hkv, d)).astype(np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_ref_matches_reference(shape, causal, dtype):
    """o against the reference's Pallas kernel (interpret) and `mha_ref`;
    lse against the reference's blockwise forward."""
    q, k, v = _qkv(shape)
    tt = getattr(torch, dtype)
    o, lse = tref.mha_ref(*(torch.from_numpy(a).to(tt) for a in (q, k, v)),
                          causal=causal)
    b, tq, tk, hq, hkv, d = shape
    assert o.dtype == tt and o.shape == (b, tq, hq, d)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, tq)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    tol = TOL[dtype]
    _close(o.float(), r_ops.attention(jq, jk, jv, causal=causal,
                                      use_pallas=True, interpret=True), tol)
    _close(o.float(), r_ref.mha_ref(jq, jk, jv, causal=causal), tol)
    _, (_, _, _, _, r_lse) = r_bw._fwd(jq, jk, jv, causal, None, 0, 512)
    _close(lse, np.asarray(r_lse).reshape(b, hq, tq), TOL["float32"])


@pytest.mark.parametrize("shape", [(1, 64, 192, 4, 2, 32),
                                   (2, 48, 48, 4, 1, 16),
                                   (1, 600, 600, 4, 2, 16)])
def test_attention_grads_match_reference(shape):
    """`ops.attention`'s backward (the blockwise recomputation over the
    forward's lse) against jax.grad of the reference's blockwise attention
    and of its `mha_ref`; 600 keys take two 512-key blocks."""
    q, k, v = _qkv(shape, seed=1)
    w = np.random.default_rng(2).normal(
        size=(shape[0], shape[1], shape[3], shape[5])).astype(np.float32)
    tq_, tk_, tv_ = (torch.from_numpy(a).requires_grad_(True)
                     for a in (q, k, v))
    (tops.attention(tq_, tk_, tv_, causal=True) * torch.from_numpy(w)) \
        .sum().backward()
    jw = jnp.asarray(w)
    for fn in (lambda a, b_, c: r_bw.blockwise_attention(a, b_, c, True),
               lambda a, b_, c: r_ref.mha_ref(a, b_, c, causal=True)):
        grads = jax.jit(jax.grad(lambda a, b_, c: jnp.sum(fn(a, b_, c) * jw),
                                 argnums=(0, 1, 2)))(
            *(jnp.asarray(a) for a in (q, k, v)))
        for got, want in zip((tq_, tk_, tv_), grads):
            np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                       **GRAD_TOL)


def test_attention_gradcheck_float64():
    """Float64 inputs run the plain forward and the backward in float64."""
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(rng.normal(size=s)).requires_grad_(True)
            for s in ((1, 5, 4, 8), (1, 7, 2, 8), (1, 7, 2, 8))]
    for causal in (True, False):
        assert torch.autograd.gradcheck(
            lambda q, k, v: tops.attention(q, k, v, causal=causal), args)


@pytest.mark.parametrize("tq,tk,window,block_k", [
    (40, 40, 0, 16), (30, 70, 0, 32), (64, 64, 24, 16), (1024, 1024, 0, 512)])
def test_blockwise_attention_matches_reference(tq, tk, window, block_k):
    """Forward and gradients of the ported blockwise attention against the
    reference's, with ragged kv blocks, Tq < Tk and a local window."""
    shape = (2, tq, tk, 4, 2, 16)
    q, k, v = _qkv(shape, seed=4)
    w = np.random.default_rng(5).normal(size=(2, tq, 4, 16)).astype(
        np.float32)
    targs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = t_bw.blockwise_attention(*targs, True, None, window, block_k)
    (o * torch.from_numpy(w)).sum().backward()

    def loss(a, b_, c):
        return jnp.sum(r_bw.blockwise_attention(a, b_, c, True, None, window,
                                                block_k) * jnp.asarray(w))

    jargs = [jnp.asarray(a) for a in (q, k, v)]
    ro = jax.jit(lambda a, b_, c: r_bw.blockwise_attention(
        a, b_, c, True, None, window, block_k))(*jargs)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ro),
                               atol=1e-5, rtol=1e-5)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*jargs)
    for got, want in zip(targs, grads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   **GRAD_TOL)


def _gqa_weights(cfg, seed=6):
    rng = np.random.default_rng(seed)
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": rng.normal(size=(d, h, hd)) / d ** 0.5,
            "wk": rng.normal(size=(d, hkv, hd)) / d ** 0.5,
            "wv": rng.normal(size=(d, hkv, hd)) / d ** 0.5,
            "wo": rng.normal(size=(h, hd, d)) / (h * hd) ** 0.5}


@pytest.mark.parametrize("t", [16, 1024])
def test_gqa_apply_and_prefill_match_reference(t):
    """gemma-2b reduced (4 q heads over 1 kv head): `gqa_apply` with and
    without flash and `gqa_prefill` (output and cache) against the
    reference's, dense at 16 tokens and blockwise at 1024."""
    rcfg, tcfg = r_get_config("gemma-2b").reduced(), \
        t_get_config("gemma-2b").reduced()
    w = {k: v.astype(np.float32) for k, v in _gqa_weights(rcfg).items()}
    x = np.random.default_rng(t).normal(size=(2, t, rcfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (2, t)).copy()
    rp = {k: jnp.asarray(v) for k, v in w.items()}
    tp = {k: torch.from_numpy(v) for k, v in w.items()}
    jx, jpos = jnp.asarray(x), jnp.asarray(pos)
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
    want = jax.jit(lambda p, a, b_: r_attn.gqa_apply(p, rcfg, a, b_))(
        rp, jx, jpos)
    # under jax.jit XLA computes the RoPE frequencies theta^(-2i/D) up to
    # one float32 ulp off its own eager result, which at positions near
    # 1023 moves roped values by up to 1.1e-5 (the port equals the eager
    # reference to 2.4e-7): atol 3e-5 from 1024 tokens, 1e-5 below
    tol = dict(atol=3e-5 if t >= 1024 else 1e-5, rtol=1e-5)
    for flash in (False, True):
        got = t_attn.gqa_apply(tp, tcfg, tx, tpos, use_flash=flash)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    ry, rc = jax.jit(lambda p, a, b_: r_attn.gqa_prefill(p, rcfg, a, b_,
                                                         t + 4))(rp, jx, jpos)
    ty, tc = t_attn.gqa_prefill(tp, tcfg, tx, tpos, t + 4)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), **tol)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(rc[name]),
                                   **tol)


def test_kernel_wrapper_takes_only_cuda_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 8, 8, 2, 1, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    # meta (the dry run) takes the plain version by the named rule
    o = tops.attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert o.device.type == "meta" and o.shape == q.shape


def test_kernel_source_and_build_location():
    assert tflash.SOURCE.is_file()
    path = kernel_build.library_path(tflash.SOURCE)
    assert path.name.startswith("flash_attention_") and path.suffix == ".so"
    assert path.parent == kernel_build.BUILD_DIR
    src = tflash.SOURCE.read_text()
    assert "src/repro/kernels/flash_attention.py::" in src
    assert "_flash_kernel" in src
    assert 'extern "C" int flash_attention_launch' in src


@pytest.mark.parametrize("q_shape,kv_shape,dtype,offset,want", [
    # gemma-2b's train shape in bf16: the wgmma/TMA kernel
    ((1, 2048, 8, 256), (1, 2048, 1, 256), torch.bfloat16, 0, "sm90"),
    # the reference test's shapes in bf16, D = 32 and 64
    ((1, 64, 4, 32), (1, 192, 2, 32), torch.bfloat16, 0, "sm90"),
    ((2, 128, 4, 64), (2, 128, 2, 64), torch.bfloat16, 0, "sm90"),
    # D = 96 and 200: padded to 128 and 256 by the box's zero fill
    ((1, 37, 4, 96), (1, 60, 2, 96), torch.bfloat16, 0, "sm90"),
    ((2, 16, 2, 200), (2, 16, 1, 200), torch.bfloat16, 0, "sm90"),
    # wider than the kernels take
    ((1, 16, 2, 264), (1, 16, 1, 264), torch.bfloat16, 0, "simt"),
    # float32 stays on the SIMT kernel
    ((1, 2048, 8, 256), (1, 2048, 1, 256), torch.float32, 0, "simt"),
    # Hq * D = 30 and Hkv * D = 10: token strides not 16-byte multiples
    ((1, 16, 3, 10), (1, 16, 1, 10), torch.bfloat16, 0, "simt"),
    # Hq * D = 24 is, but the head stride (D = 12) is not
    ((1, 16, 2, 12), (1, 16, 1, 12), torch.bfloat16, 0, "simt"),
    # data 2 bytes past a 16-byte boundary
    ((1, 16, 2, 64), (1, 16, 1, 64), torch.bfloat16, 1, "simt"),
])
def test_route_rule(q_shape, kv_shape, dtype, offset, want):
    """`route` picks the kernel from dtype, shape, strides and alignment:
    bf16 that TMA can address goes to the wgmma/TMA kernel, the rest to
    the SIMT kernel."""
    def make(shape):
        n = int(np.prod(shape))
        return torch.zeros(n + 8, dtype=dtype)[offset:offset + n].view(shape)
    q, k, v = make(q_shape), make(kv_shape), make(kv_shape)
    assert tflash.route(q, k, v) == want
    # a non-contiguous view never goes to the TMA kernel
    assert tflash.route(q.transpose(1, 2), k, v) == "simt"


def test_launches_sums_both_kernels_counts():
    """`launches()` is the sum of the two wrappers' own counts, so a
    direct call of either kernel moves it as a routed call does."""
    saved = (tflash.flash_attention_sm90.launches,
             tflash.flash_attention_simt.launches)
    try:
        tflash.flash_attention_sm90.launches = 5
        tflash.flash_attention_simt.launches = 3
        assert tflash.launches() == 8
        tflash.flash_attention_simt.launches += 1
        assert tflash.launches() == 9
    finally:
        (tflash.flash_attention_sm90.launches,
         tflash.flash_attention_simt.launches) = saved


def test_sm90_kernel_source_and_build_location():
    assert tflash.SOURCE_SM90.is_file()
    path = kernel_build.library_path(tflash.SOURCE_SM90)
    assert path.name.startswith("flash_attention_sm90_") and \
        path.suffix == ".so"
    assert path.parent == kernel_build.BUILD_DIR
    src = tflash.SOURCE_SM90.read_text()
    assert "src/repro/kernels/flash_attention.py::" in src
    assert "_flash_kernel" in src
    assert 'extern "C" int flash_attention_sm90_launch' in src
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier"):
        assert ptx in src


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """Both kernels against `mha_ref` on the card, o and lse, on the
    reference test's shapes plus gemma's head (D = 256) and Tq > Tk: the
    routed call (bf16 to the wgmma/TMA kernel, float32 to SIMT, asserted by
    their launch counts) and the SIMT kernel in bf16; bf16 o also within a
    relative L2 distance of 1e-2 (chip_smoke.FLASH_BF16_REL_L2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape in SHAPES + [(1, 300, 300, 8, 1, 256), (1, 90, 40, 4, 2, 64),
                           (1, 70, 130, 4, 2, 96)]:
        for dtype in ("float32", "bfloat16"):
            tt = getattr(torch, dtype)
            q, k, v = (torch.from_numpy(a).to(dev).to(tt) for a in _qkv(shape))
            kernels = [tflash.flash_attention]
            if dtype == "bfloat16":
                kernels.append(tflash.flash_attention_simt)
            for causal in (True, False):
                for fn in kernels:
                    before = (tflash.flash_attention_sm90.launches,
                              tflash.flash_attention_simt.launches)
                    o, lse = fn(q, k, v, causal=causal)
                    moved = (tflash.flash_attention_sm90.launches - before[0],
                             tflash.flash_attention_simt.launches - before[1])
                    sm90 = fn is tflash.flash_attention and \
                        dtype == "bfloat16"
                    assert moved == ((1, 0) if sm90 else (0, 1)), moved
                    op, lsep = tref.mha_ref(q, k, v, causal=causal)
                    _close(o.float().cpu(), op.float().cpu(), TOL[dtype])
                    _close(lse.cpu(), lsep.cpu(), 1e-5)
                    if dtype == "bfloat16":
                        rel = (o.float() - op.float()).norm() / \
                            op.float().norm()
                        assert float(rel) <= 1e-2, (shape, causal, float(rel))
