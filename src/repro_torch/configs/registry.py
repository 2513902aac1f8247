"""Published architecture configurations.

Port of `repro.configs.registry`; it carries the configurations whose
families are ported: gemma-2b, the serve default (dense GQA/MQA attention,
GeGLU), recurrentgemma-9b (hybrid: RG-LRU recurrent blocks and
sliding-window local attention, 2:1) and xlstm-125m (ssm: mLSTM and sLSTM
blocks, 3:1). The other families wait.
"""
from __future__ import annotations

import dataclasses

from .base import ArchConfig

_REGISTRY: dict[str, ArchConfig] = {}


def _reg(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


# --- [dense] GeGLU, head_dim=256, MQA [arXiv:2403.08295; hf] ----------------
GEMMA_2B = _reg(ArchConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000,
    gating="geglu", tie_embeddings=True,
    microbatches=2,
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
