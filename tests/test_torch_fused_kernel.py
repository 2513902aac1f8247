"""Port vs reference: one fused ADRA access over the whole op surface.

The port's plain version (`fused_planes_op_ref`) and its wrapper on CPU
tensors are held bit for bit against the reference's Pallas kernel run in
interpret mode and its `jnp-boolean` backend, at n_bits 2-32 and widths
that are not multiples of 32 or of the Pallas block. The CUDA kernel itself
runs only on a card: its case carries the `cuda` marker and skips here.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cim import backends as rbk
from repro.cim import engine as reng
from repro.cim.fused_kernel import fused_planes_op as r_fused
from repro.cim.planepack import PlanePack as RPack
from repro_torch import PLAIN_DEVICES, kernel_build
from repro_torch.cim import backends as tbk
from repro_torch.cim import engine as teng
from repro_torch.cim import fused_kernel as tfk
from repro_torch.cim import opset
from repro_torch.cim.accounting import LEDGER as TLEDGER
from repro_torch.cim.planepack import PlanePack as TPack


def _planes(seed, n_bits, w):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, (n_bits, w), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (n_bits, w), dtype=np.uint64).astype(np.uint32)
    return a, b


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.view(np.int32))


def _check(got, want, ops):
    assert len(got) == len(want) == len(ops)
    for op, g, r in zip(ops, got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(r), err_msg=op)


@pytest.mark.parametrize("n_bits", list(range(2, 33)))
def test_plain_version_matches_jnp_boolean_full_surface(n_bits):
    w = (37, 70, 513)[n_bits % 3]
    a, b = _planes(n_bits, n_bits, w)
    rng = random.Random(n_bits)
    for ops in (opset.ALL_OPS,
                tuple(rng.sample(opset.ALL_OPS, rng.randint(1, 8)))):
        want = rbk._jnp_boolean_backend(jnp.asarray(a), jnp.asarray(b), ops)
        _check(tfk.fused_planes_op_ref(_t(a), _t(b), ops), want, ops)
        _check(tfk.fused_planes_op(_t(a), _t(b), ops), want, ops)


@pytest.mark.parametrize("n_bits", [2, 9, 32])
def test_plain_version_matches_pallas_interpret(n_bits):
    a, b = _planes(100 + n_bits, n_bits, 515)      # ragged vs block_w=512
    ops = opset.ALL_OPS
    want = r_fused(jnp.asarray(a), jnp.asarray(b), ops, interpret=True)
    _check(tfk.fused_planes_op_ref(_t(a), _t(b), ops), want, ops)


@pytest.mark.parametrize("op", opset.ALL_OPS)
def test_every_single_op_matches_reference(op):
    a, b = _planes(7, 13, 45)
    want = rbk._jnp_boolean_backend(jnp.asarray(a), jnp.asarray(b), (op,))
    _check(tfk.fused_planes_op(_t(a), _t(b), (op,)), want, (op,))


def test_tiled_stack_equals_per_tile_calls():
    a, b = _planes(8, 5, 3 * 40)
    ta = _t(a).reshape(5, 3, 40).permute(1, 0, 2).contiguous()
    tb = _t(b).reshape(5, 3, 40).permute(1, 0, 2).contiguous()
    tiled = tfk.fused_planes_op(ta, tb, ("sub", "eq", "xor"))
    for i in range(3):
        flat = tfk.fused_planes_op(ta[i], tb[i], ("sub", "eq", "xor"))
        for x, y in zip(tiled, flat):
            assert torch.equal(x[i], y)


def test_cpu_wrapper_uses_plain_version_and_never_counts_a_launch():
    a, b = _planes(9, 4, 33)
    before = tfk.fused_planes_op.launches
    tfk.fused_planes_op(_t(a), _t(b), ("add",))
    assert tfk.fused_planes_op.launches == before


def test_cpu_wrapper_counts_no_bytes():
    a, b = _planes(9, 4, 33)
    before = tfk.fused_planes_op.bytes
    tfk.fused_planes_op(_t(a), _t(b), ("add", "lt", "xor"))
    assert tfk.fused_planes_op.bytes == before


@pytest.mark.cuda
def test_launch_counts_the_bytes_it_must_move():
    """Each launch adds (2 n_bits + output rows) x W x 4 bytes per tile:
    both stacks read once, every output plane written once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    a, b = (_t(x).cuda() for x in _planes(9, 3 * 5, 33))
    a, b = a.view(3, 5, 33), b.view(3, 5, 33)
    before = tfk.fused_planes_op.bytes
    tfk.fused_planes_op(a, b, ("add", "lt", "xor"))
    assert tfk.fused_planes_op.bytes - before == \
        (2 * 5 + (5 + 1) + 1 + 5) * 33 * 4 * 3


def test_wrapper_raises_where_no_kernel_exists():
    """Malformed requests raise; `meta` tensors (the dry run's) take the
    plain version by the named rule `repro_torch.takes_plain`, which never
    covers CUDA."""
    a = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    out = tfk.fused_planes_op(a, a, ("add",))
    assert out[0].device.type == "meta" and out[0].shape == (5, 8)
    assert PLAIN_DEVICES == ("cpu", "meta") and "cuda" not in PLAIN_DEVICES
    with pytest.raises(opset.CimOpError):
        tfk.fused_planes_op(torch.zeros((4, 8), dtype=torch.int32),
                            torch.zeros((4, 9), dtype=torch.int32), ("add",))
    with pytest.raises(opset.CimOpError):
        tfk.fused_planes_op(torch.zeros((4, 8), dtype=torch.int32),
                            torch.zeros((4, 8), dtype=torch.int32), ("add", "add"))


def test_kernel_source_and_build_location():
    assert tfk.SOURCE.is_file()
    path = kernel_build.library_path(tfk.SOURCE)
    assert path.parent.name == "repro_torch_kernels"
    assert path.parent.parent.name == "build"
    assert "sm_90a" in " ".join(kernel_build.NVCC_FLAGS)


def test_backend_registry_resolution(monkeypatch):
    assert set(tbk.available_backends()) == {"fused", "torch-boolean",
                                             "analog-oracle"}
    monkeypatch.delenv(tbk.ENV_VAR, raising=False)
    assert tbk.get_backend().name == "fused"
    monkeypatch.setenv(tbk.ENV_VAR, "torch-boolean")
    assert tbk.get_backend().name == "torch-boolean"
    monkeypatch.setenv(tbk.ENV_VAR, "pallas-tpu")
    with pytest.raises(KeyError):
        tbk.get_backend()


@pytest.mark.parametrize("ops", [("add",), ("sub", "lt", "eq", "gt"),
                                 ("and", "xor", "carry_add")])
def test_engine_execute_matches_reference_outputs_and_ledger(ops):
    rng = np.random.default_rng(11)
    x = rng.integers(-2 ** 11, 2 ** 11, (4, 21)).astype(np.int32)
    y = rng.integers(0, 2 ** 9, (4, 21)).astype(np.int32)
    ra = RPack.pack(jnp.asarray(x), 12)
    rbp = RPack.pack(jnp.asarray(y), 9, signed=False)
    ta = TPack.pack(torch.from_numpy(x), 12)
    tbp = TPack.pack(torch.from_numpy(y), 9, signed=False)
    from repro.cim.accounting import LEDGER as RLEDGER
    RLEDGER.reset()
    TLEDGER.reset()
    rout = reng.execute(ra, rbp, ops)
    tout = teng.execute(ta, tbp, ops)
    for op in ops:
        assert tout[op].n_bits == rout[op].n_bits
        np.testing.assert_array_equal(tout[op].planes.numpy().view(np.uint32),
                                      np.asarray(rout[op].planes))
        np.testing.assert_array_equal(tout[op].unpack().numpy(),
                                      np.asarray(rout[op].unpack()))
    for f in ("accesses", "words32", "per_op", "bank_accesses",
              "activated_words32", "load_accesses"):
        assert getattr(TLEDGER, f) == getattr(RLEDGER, f), f
    assert teng.traffic_model_bytes(13, 777, ops) == \
        reng.traffic_model_bytes(13, 777, ops)
    TLEDGER.reset()


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for n_bits in (2, 16, 33):
        a, b = _planes(n_bits, n_bits, 4099)
        ca, cb = _t(a).to(dev), _t(b).to(dev)
        got = tfk.fused_planes_op(ca, cb, opset.ALL_OPS)
        want = tfk.fused_planes_op_ref(ca, cb, opset.ALL_OPS)
        for g, r in zip(got, want):
            assert torch.equal(g, r)
