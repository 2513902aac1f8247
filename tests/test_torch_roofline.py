"""Port vs reference: the roofline terms (`launch/roofline.py`).

The reference's ten cases (`tests/test_roofline.py`) run against the port:
the HLO collective parser, the sub-byte shape rule, `RooflineTerms` with a
device override, the analytic models and the MoE active-parameter count.
The port's default device row is an H100 SXM, so `to_dict()["device"]` is
"h100-sxm" where the reference's is "tpu-v5e" (by design). Then the
analytic FLOPs and bytes and `model_flops` are held to the reference's for
all ten configs x the four `SHAPES`, the port's parameter tree built on
`meta` and the reference's by `jax.eval_shape`; and grok-1-314b's active
parameter count is the reference's.
"""
import jax
import numpy as np
import pytest

from repro.configs import SHAPES as RSHAPES
from repro.configs import get_config as rget
from repro.launch import roofline as rrl
from repro.models import build as rbuild
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import roofline as rl
from repro_torch.models.model import build

HLO = """
HloModule test
ENTRY %main {
  %p0 = bf16[128,256]{1,0} parameter(0)
  %p1 = f32[64]{0} parameter(1)
  %ag = bf16[2048,256]{1,0} all-gather(%p0), replica_groups={}
  %ar.1 = f32[64]{0} all-reduce(%p1), to_apply=%add
  %rs = bf16[8,256]{1,0} reduce-scatter(%p0), to_apply=%add
  %a2a = bf16[128,256]{1,0} all-to-all(%p0)
  %cp = f32[64]{0} collective-permute(%p1)
  %ars = f32[64]{0} all-reduce-start(%p1)
  %ard = f32[64]{0} all-reduce-done(%ars)
  ROOT %t = (bf16[128,256]{1,0}) tuple(%a2a)
}
"""


def test_collective_parser_sums_operand_bytes():
    st = rl.collective_bytes(HLO)
    p0 = 128 * 256 * 2
    p1 = 64 * 4
    assert st.bytes_by_op["all-gather"] == p0
    # plain all-reduce + all-reduce-start counted, -done deduped
    assert st.bytes_by_op["all-reduce"] == 2 * p1
    assert st.count_by_op["all-reduce"] == 2
    assert st.bytes_by_op["reduce-scatter"] == p0
    assert st.bytes_by_op["all-to-all"] == p0
    assert st.bytes_by_op["collective-permute"] == p1
    ref = rrl.collective_bytes(HLO)
    assert st.bytes_by_op == ref.bytes_by_op
    assert st.count_by_op == ref.count_by_op


def test_collective_parser_tuple_shapes():
    hlo = "%x = (bf16[4,4]{1,0}, f32[2]{0}) all-reduce(%a, %b)\n%a = bf16[4,4]{1,0} add(%x, %x)\n%b = f32[2]{0} add(%x, %x)\n"
    st = rl.collective_bytes(hlo)
    assert st.bytes_by_op["all-reduce"] == 4 * 4 * 2 + 2 * 4


def test_shape_bytes_subbyte_dtypes_round_once():
    """4-bit dtypes contribute exact bit totals, rounded up to bytes ONCE
    per instruction — s4[7] is 4 bytes, never a fractional 3.5."""
    assert rl._shape_bytes("s4[7]") == 4           # 28 bits -> ceil 4
    assert rl._shape_bytes("u4[8]") == 4           # exact 32 bits
    assert rl._shape_bytes("s4[101]") == 51        # 404 bits -> ceil 51
    # tuples accumulate bits BEFORE the single round-up
    assert rl._shape_bytes("(s4[1], s4[1])") == 1  # 8 bits, not 1+1
    assert rl._shape_bytes("(s4[3], u4[3])") == 3  # 24 bits, not 2+2
    assert rl._shape_bytes("bf16[4,4]") == 32
    assert rl._shape_bytes("token[]") == 0


def test_collective_parser_s4_operands():
    hlo = ("%q = s4[101]{0} parameter(0)\n"
           "%ag = s4[101]{0} all-gather(%q), replica_groups={}\n")
    st = rl.collective_bytes(hlo)
    assert st.bytes_by_op["all-gather"] == 51      # ceil(101*4/8)


def test_roofline_terms_accept_device_spec_override():
    from repro_torch.cim.cost import DeviceSpec

    slow = DeviceSpec(name="half-speed", peak_flops=rl.PEAK_FLOPS / 2,
                      hbm_bw=rl.HBM_BW / 2, ici_bw=rl.ICI_BW)
    base = rl.RooflineTerms(flops_global=197e12, bytes_global=819e9,
                            collective_bytes_per_chip=0.0, n_chips=1,
                            model_flops=197e12)
    over = rl.RooflineTerms(flops_global=197e12, bytes_global=819e9,
                            collective_bytes_per_chip=0.0, n_chips=1,
                            model_flops=197e12, device=slow)
    assert over.t_compute == pytest.approx(2 * base.t_compute)
    assert over.t_memory == pytest.approx(2 * base.t_memory)
    # departure by design: the port's default row is the H100's
    assert base.to_dict()["device"] == "h100-sxm"
    assert over.to_dict()["device"] == "half-speed"


def test_module_constants_come_from_default_device():
    from repro_torch.cim.cost import DEFAULT_DEVICE

    assert rl.PEAK_FLOPS == DEFAULT_DEVICE.peak_flops
    assert rl.HBM_BW == DEFAULT_DEVICE.hbm_bw
    assert rl.ICI_BW == DEFAULT_DEVICE.ici_bw


def test_roofline_terms_and_bottleneck():
    from repro_torch.cim.cost import DeviceSpec

    v5e = DeviceSpec(name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
                     ici_bw=50e9)
    t = rl.RooflineTerms(flops_global=197e12 * 256, bytes_global=819e9,
                         collective_bytes_per_chip=50e9, n_chips=256,
                         model_flops=197e12 * 128, device=v5e)
    assert t.t_compute == pytest.approx(1.0)
    assert t.t_memory == pytest.approx(1.0 / 256)
    assert t.t_collective == pytest.approx(1.0)
    assert t.bottleneck in ("compute", "collective")
    assert t.useful_flops_ratio == pytest.approx(0.5)
    assert t.roofline_fraction == pytest.approx(0.5)
    ref = rrl.RooflineTerms(flops_global=197e12 * 256, bytes_global=819e9,
                            collective_bytes_per_chip=50e9, n_chips=256,
                            model_flops=197e12 * 128)
    assert t.to_dict() == pytest.approx(ref.to_dict())


def test_analytic_flops_scales_sanely():
    cfg = get_config("llama3.2-1b")
    train = rl.analytic_flops(cfg, SHAPES["train_4k"])
    prefill = rl.analytic_flops(cfg, SHAPES["prefill_32k"])
    decode = rl.analytic_flops(cfg, SHAPES["decode_32k"])
    # train is fwd x4 over ~1M tokens; decode is 1 token/seq
    assert train > prefill > decode > 0
    # vs 6*N*D: same order of magnitude (attention + remat inflate)
    n = 1.10e9  # non-embedding params
    d = 256 * 4096
    assert 0.5 < train / (6 * n * d * 4 / 3) < 3.0


def test_analytic_flops_moe_counts_capacity_not_all_experts():
    ds = get_config("deepseek-v2-lite-16b")
    fl = rl.analytic_flops(ds, SHAPES["train_4k"])
    # dense-equivalent (all 64 experts) would be ~8x the top-6 routed figure
    import dataclasses
    dense_like = dataclasses.replace(
        ds, moe=dataclasses.replace(ds.moe, top_k=ds.moe.n_experts,
                                    capacity_factor=1.0))
    fl_dense = rl.analytic_flops(dense_like, SHAPES["train_4k"])
    assert fl_dense > 3 * fl


def test_active_param_count_scales_moe():
    cfg = get_config("grok-1-314b")
    params = build(cfg, device="meta").params()
    from repro_torch.tree import leaves

    total = sum(np.prod(l.shape) for l in leaves(params))
    active = rl.active_param_count(cfg, params)
    assert total > 3.0e11            # ~314 B params materialized
    assert active < 0.45 * total     # top-2 of 8 experts dominate the count
    rcfg = rget("grok-1-314b")
    rparams = jax.eval_shape(rbuild(rcfg).init, jax.random.PRNGKey(0))
    assert active == rrl.active_param_count(rcfg, rparams)
    assert total == sum(np.prod(l.shape) for l in jax.tree.leaves(rparams))


# ---------------------------------------------------------------------------
# the analytic models against the reference: ten configs x four shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_terms_match_reference(arch):
    cfg, rcfg = get_config(arch), rget(arch)
    params = build(cfg, device="meta").params()
    rparams = jax.eval_shape(rbuild(rcfg).init, jax.random.PRNGKey(0))
    assert rl.active_param_count(cfg, params) == \
        rrl.active_param_count(rcfg, rparams)
    for name, shape in SHAPES.items():
        rshape = RSHAPES[name]
        assert (shape.seq_len, shape.global_batch, shape.kind) == \
            (rshape.seq_len, rshape.global_batch, rshape.kind)
        assert rl.analytic_flops(cfg, shape) == \
            rrl.analytic_flops(rcfg, rshape), (arch, name)
        assert rl.analytic_bytes(cfg, shape, 3.0e9, 1.5e9) == \
            rrl.analytic_bytes(rcfg, rshape, 3.0e9, 1.5e9), (arch, name)
        assert rl.model_flops(cfg, params, shape) == \
            rrl.model_flops(rcfg, rparams, rshape), (arch, name)
