"""Published architecture configurations.

Port of `repro.configs.registry`: the reference's ten configurations,
field for field (sources cited per entry). Every entry is selectable with
--arch in the launchers. grok-1-314b (bf16 parameters, 628 GB) is
registered for reduced runs: it does not fit one card at full width.
"""
from __future__ import annotations

import dataclasses

from .base import ArchConfig, MLAConfig, MoEConfig

_REGISTRY: dict[str, ArchConfig] = {}


def _reg(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


# --- [audio] decoder-only over EnCodec tokens [arXiv:2306.05284; hf] --------
MUSICGEN_LARGE = _reg(ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048,
    gating="none",                    # musicgen uses plain GELU FFN
    embed_stub=True,                  # EnCodec frame embeddings as `embeds`
))

# --- [moe] 8 experts top-2 [hf:xai-org/grok-1; unverified] ------------------
GROK_1_314B = _reg(ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab_size=131072,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768),
    expert_sharding="tp",             # 8 experts < 16-way model axis
    param_dtype="bfloat16",           # 314B: f32 params = 4.9 GB/chip alone
    opt_state_dtype="bfloat16",       # 314B: f32 m/v would not fit one pod
    microbatches=8,                   # activation residency / 8
))

# --- [moe] MLA kv_lora=512, 2 shared + 64 routed top-6 [arXiv:2405.04434; hf]
DEEPSEEK_V2_LITE = _reg(ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    first_dense_layers=1,             # layer 0 is a dense 10944-wide FFN
    d_ff_first_dense=10944,
    microbatches=4,
))

# --- [dense] small llama3 [hf:meta-llama/Llama-3.2-1B; unverified] ----------
LLAMA32_1B = _reg(ArchConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=128256, rope_theta=500_000.0,
    tie_embeddings=True,
))

# --- [dense] qk_norm, GQA [hf:Qwen/Qwen3-8B; hf] ----------------------------
QWEN3_14B = _reg(ArchConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab_size=151936, rope_theta=1_000_000.0,
    qk_norm=True,
))

# --- [dense] GeGLU, head_dim=256, MQA [arXiv:2403.08295; hf] ----------------
GEMMA_2B = _reg(ArchConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000,
    gating="geglu", tie_embeddings=True,
    microbatches=2,
))

# --- [dense] GQA [hf:ibm-granite/granite-3.0-2b-base; hf] -------------------
GRANITE_3_8B = _reg(ArchConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12800, vocab_size=49155,
))

# --- [hybrid] RG-LRU + local attn 1:2 [arXiv:2402.19427; unverified] --------
RECURRENTGEMMA_9B = _reg(ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    gating="geglu",
    block_pattern=("rec", "rec", "local"),   # Griffin 2:1 recurrent:local
    local_window=2048,
    sub_quadratic=True,
    microbatches=2,
))

# --- [ssm] sLSTM + mLSTM blocks [arXiv:2405.04517; unverified] --------------
XLSTM_125M = _reg(ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
    d_ff=0, vocab_size=50304,
    gating="none",
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),  # mLSTM-dominant mix
    sub_quadratic=True,
    tensor_parallel=False,            # 125M: TP all-reduces would dominate
))

# --- [vlm] InternViT frontend (stub) + InternLM2 backbone [arXiv:2404.16821]
INTERNVL2_26B = _reg(ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92553,
    embed_stub=True,                  # patch embeddings as `embeds`
))


ARCH_IDS = tuple(sorted(_REGISTRY))


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return _REGISTRY[name]


def preset_config(name: str, preset: str) -> ArchConfig:
    """`repro.launch.train.preset_config`: the published config ("full"),
    its CPU-test reduction ("reduced") or a ~100M-parameter same-family
    variant ("100m")."""
    cfg = get_config(name)
    if preset == "reduced":
        return cfg.reduced()
    if preset == "100m":
        return dataclasses.replace(
            cfg.reduced(), name=cfg.name + "-100m",
            n_layers=8, d_model=768, n_heads=12,
            n_kv_heads=min(cfg.n_kv_heads, 4), head_dim=64,
            d_ff=3072 if cfg.d_ff else 0, vocab_size=32768)
    if preset == "full":
        return cfg
    raise ValueError(f"unknown preset {preset!r}; use reduced, 100m or full")
