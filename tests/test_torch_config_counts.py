"""Port vs reference: one reduced int8 CiM decode step (`--cim-lower`) of
llama3.2-1b (dense GQA, every MLP and attention contraction on CiM) and
deepseek-v2-lite-16b (only its dense layer 0's MLP on CiM; MoE and MLA in
float, as the reference), cold and warm, streamed and resident.

Weights come from the reference's init through `params_from_jax`. The
`jax.core.Literal`/`Var` aliases the reference's lowering needs under JAX
0.9 are applied inside the test only. Counts are exact; logits at the
reference's teacher-forcing tolerance 2e-4.
"""
import dataclasses

import jax
import jax.extend.core as jex
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cim import array as rarray
from repro.cim import dispatch as rdisp
from repro.cim.accounting import LEDGER as RLEDGER
from repro.configs import get_config as r_get_config
from repro.models import attention as rattn
from repro.models import build as rbuild
from repro.models import layers as rlayers
from repro_torch.cim import array as tarray
from repro_torch.cim import dispatch as tdisp
from repro_torch.cim.accounting import LEDGER as TLEDGER
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models.model import Model

MODEL_TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(autouse=True)
def _fresh_state():
    for clear in (TLEDGER.reset, tarray.clear_resident,
                  tdisp.clear_schedule_cache, rdisp.clear_schedule_cache,
                  RLEDGER.reset, rarray.clear_resident):
        clear()
    yield
    for clear in (TLEDGER.reset, tarray.clear_resident,
                  tdisp.clear_schedule_cache, rdisp.clear_schedule_cache,
                  RLEDGER.reset, rarray.clear_resident):
        clear()


@pytest.fixture
def ref_lowering(monkeypatch):
    """The reference's lowering under JAX 0.9, for this test only."""
    monkeypatch.setattr(jax.core, "Literal", jex.Literal, raising=False)
    monkeypatch.setattr(jax.core, "Var", jex.Var, raising=False)
    yield
    rlayers._LOWERED_MLP.clear()
    rlayers._LOWERED_LINEAR.clear()
    rattn._LOWERED_SDPA.clear()


@pytest.mark.parametrize("arch,accesses,dispatches", [
    # 2 layers x [K = 64, 64, 128 (MLP), 16 (QK^T), 8 (AV)]
    ("llama3.2-1b", 2 * (21 + 21 + 22 + 19 + 18), 2 * 5),
    # layer 0's dense MLP alone, K = 64, 64, 10944 (the reduced config
    # keeps d_ff_first_dense); MoE and MLA float
    ("deepseek-v2-lite-16b", 21 + 21 + 29, 3)])
@pytest.mark.parametrize("resident", [False, True])
def test_lowered_decode_step_counts_match_reference(ref_lowering, arch,
                                                    accesses, dispatches,
                                                    resident):
    """One int8 CiM decode step at 2 slots, cold then warm: accesses,
    dispatches, program and pin counters, loads and per-op charges equal
    the reference's, and the logits agree."""
    def cim(c):
        return dataclasses.replace(c.reduced(), cim_mlp_bits=8,
                                   cim_attention_bits=8,
                                   cim_unroll_groups=True,
                                   cim_resident=resident)
    rcfg, tcfg = cim(r_get_config(arch)), cim(get_config(arch))
    rmodel = rbuild(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(1))
    tmodel = Model(tcfg, params=params_from_jax(
        jax.tree.map(np.asarray, rparams), tcfg, device="cpu"))
    rcaches = rmodel.init_caches(2, 8)
    tcaches = tmodel.init_caches(2, 8)
    rstep = {"tokens": jnp.array([[1], [2]], jnp.int32),
             "positions": jnp.array([3, 5], jnp.int32)}
    tstep = {"tokens": torch.tensor([[1], [2]]),
             "positions": torch.tensor([3, 5], dtype=torch.int32)}
    for step in range(2):
        RLEDGER.reset()
        TLEDGER.reset()
        r0, t0 = rdisp.cache_stats(), tdisp.cache_stats()
        _, rlog = rmodel.decode_step(rparams, rcaches, rstep)
        _, tlog = tmodel.decode_step(tcaches, tstep)
        r1, t1 = rdisp.cache_stats(), tdisp.cache_stats()
        assert TLEDGER.accesses == RLEDGER.accesses == accesses, step
        assert t1["dispatches"] - t0["dispatches"] == \
            r1["dispatches"] - r0["dispatches"] == dispatches
        for c in ("misses", "hits", "resident_pins", "resident_hits"):
            assert t1[c] - t0[c] == r1[c] - r0[c], (step, c)
        for f in ("load_accesses", "words32", "resident_reuses", "per_op"):
            assert getattr(TLEDGER, f) == getattr(RLEDGER, f), (step, f)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog),
                                   **MODEL_TOL)
