"""The program's byte counter of the fused bit-plane kernel, which
`fused_planes_roofline` reads, held to the benchmark's own formula: a
launch over t tiles of n_bits planes of W words reads both stacks once and
writes each output once, (2 n_bits + output rows) x W x 4 bytes a tile,
an output's rows n_bits + 1 for add and sub, 1 for a predicate and n_bits
for a Boolean function. On the card only (the kernel has no CPU form):
one warm CiM prefill and decode step of the tiny model, run eagerly so
every launch passes the launcher, and replayed from its graphs."""
import pytest
import torch

import tiny
from portbench.harness import serve

ARITH = ("add", "sub")
PREDICATES = ("lt", "eq", "gt", "carry_add", "carry_sub")


def launch_bytes(n_bits: int, w: int, tiles: int, ops) -> int:
    rows = sum(n_bits + 1 if op in ARITH else 1 if op in PREDICATES
               else n_bits for op in ops)
    return (2 * n_bits + rows) * w * 4 * tiles


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernel has no CPU form")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_fused_byte_counter_is_the_formula(card, monkeypatch):
    from repro_torch.cim import dispatch, fused_kernel, opset
    from repro_torch.launch.serve import ServeRequest
    from portbench.harness import common

    cfg, traffic = tiny.get("dense"), tiny.get("cim")
    arch = common.with_serve_mode(common.port_arch(cfg), traffic)
    weights = common.make_weights(arch, 5, card, serving=True)
    engine = serve.build_engine(arch, traffic, weights, card)

    def requests(rid0):
        return [ServeRequest(rid=rid0 + i, prompt_len=traffic["prompt_len"],
                             gen=2, prompt=[3 + i] * traffic["prompt_len"])
                for i in range(traffic["slots"])]
    engine.run(requests(0))                 # eager first calls
    engine.run(requests(10))                # captures
    real = fused_kernel._launcher()
    seen = []

    def launcher(a, b, n_bits, w, t, mask, ptrs, stream):
        ops = [op for i, op in enumerate(opset.ALL_OPS) if mask >> i & 1]
        seen.append(launch_bytes(n_bits, w, t, ops))
        return real(a, b, n_bits, w, t, mask, ptrs, stream)
    monkeypatch.setattr(fused_kernel, "_launcher", lambda: launcher)

    b0 = fused_kernel.fused_planes_op.bytes
    with dispatch.eager_programs():
        engine.run(requests(20))
    eager = fused_kernel.fused_planes_op.bytes - b0
    assert seen and eager == sum(seen)
    b1 = fused_kernel.fused_planes_op.bytes
    engine.run(requests(30))                # replays: counts added per replay
    assert fused_kernel.fused_planes_op.bytes - b1 == eager
