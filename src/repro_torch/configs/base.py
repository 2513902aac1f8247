"""Architecture configuration.

Port of `repro.configs.base`: `ArchConfig` with the reference's fields and
derived properties, and `reduced()` for CPU tests; the dry run's workload
shapes (`ShapeSpec`, `SHAPES`, `shape_applicable`) and `input_specs`, whose
stand-ins for the reference's `jax.ShapeDtypeStruct`s are `meta` tensors of
the same shapes and dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

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


# ---------------------------------------------------------------------------
# Workload shapes (the dry run's cells)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic attention (DESIGN.md §5)."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "full-attention arch: O(S^2) attention at 512k is out of scope (DESIGN.md §5)"
    return True, ""


def input_specs(arch: ArchConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """`meta` stand-ins for every model input of this cell.

    train:   tokens/embeds + targets over the full sequence
    prefill: tokens/embeds (cache is an output)
    decode:  one new token + position (the KV/state cache of seq_len is part
             of the step signature and built on `meta` by the caller)
    """
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    act = arch.activation_dtype()

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind == "train":
        if arch.embed_stub:
            return {"embeds": meta((b, s, arch.d_model), act),
                    "targets": meta((b, s), i32)}
        return {"tokens": meta((b, s), i32), "targets": meta((b, s), i32)}
    if shape.kind == "prefill":
        if arch.embed_stub:
            return {"embeds": meta((b, s, arch.d_model), act)}
        return {"tokens": meta((b, s), i32)}
    if shape.kind == "decode":
        tok = ({"embeds": meta((b, 1, arch.d_model), act)} if arch.embed_stub
               else {"tokens": meta((b, 1), i32)})
        tok["positions"] = meta((b,), i32)
        return tok
    raise ValueError(shape.kind)
