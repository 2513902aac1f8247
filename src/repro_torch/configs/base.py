"""Architecture configuration.

Port of `repro.configs.base`: `ArchConfig` with the reference's fields and
derived properties, and `reduced()` for CPU tests. The workload shape table
and `input_specs` wait (they exist for the dry-run, which is not ported).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_renorm: bool = True


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    gating: str = "swiglu"          # swiglu | geglu | none
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    first_dense_layers: int = 0
    d_ff_first_dense: int = 0
    block_pattern: Tuple[str, ...] = ("attn",)
    local_window: int = 2048
    embed_stub: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    dtype: str = "bfloat16"         # activation dtype
    param_dtype: str = "float32"
    opt_state_dtype: str = "float32"
    remat: bool = True
    expert_sharding: str = "ep"
    sub_quadratic: bool = False
    microbatches: int = 1
    tensor_parallel: bool = True
    cim_mlp_bits: int = 0           # >0: dense MLPs run their integer
    #                                 contractions as CiM schedules
    cim_attention_bits: int = 0     # >0: GQA decode QK^T + AV as CiM
    #                                 schedules (softmax/rotary on the host)
    cim_resident: bool = False      # pin int8 MLP weight planes in the
    #                                 array's resident region across calls
    cim_unroll_groups: bool = False  # kept for parity: the port's stack is
    #                                 always unrolled (one module per layer)
    cim_host_twin: bool = False     # port-only: run the quantized host twins
    #                                 (_mlp_quantized / _sdpa_quantized)
    #                                 in place of the CiM schedules — the
    #                                 function the CiM path must match bit
    #                                 for bit

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256; pad logits are masked."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def pattern_layers(self) -> Tuple[str, ...]:
        p = self.block_pattern
        reps = -(-self.n_layers // len(p))
        return (p * reps)[: self.n_layers]

    def activation_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def param_torch_dtype(self) -> torch.dtype:
        return torch.float32 if self.param_dtype == "float32" else torch.bfloat16

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU tests (the reference's rule)."""
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, n_experts=max(2, min(4, self.moe.n_experts)),
                top_k=min(2, self.moe.top_k), d_ff_expert=64,
                n_shared=min(1, self.moe.n_shared))
        mla = None
        if self.mla is not None:
            mla = MLAConfig(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                            v_head_dim=16)
        period = len(self.block_pattern)
        return dataclasses.replace(
            self, name=self.name + "-reduced",
            n_layers=max(2, 2 * period) if period > 1 else 2,
            d_model=64, n_heads=4, n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=16, d_ff=128 if self.d_ff else 0, vocab_size=256,
            moe=moe, mla=mla, local_window=32, microbatches=1,
            dtype="float32", param_dtype="float32", remat=False)
