"""Deterministic synthetic LM data, restart-exact.

Port of `repro.data.pipeline`'s host part (numpy only, copied so the port
imports nothing of `repro`): tokens are a stateless function of (seed,
step, position), so resuming from a checkpoint at step k reproduces batch
k bit for bit with no iterator state to persist. `embed_stub_batch` is
the audio/VLM stand-in: seeded pseudo-embeddings beside the same token
targets. `sharded_batch` builds each rank's shard of the same global
batch as a DTensor on a mesh; a single-process training run moves the
numpy batch to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 32000
    batch: int = 8
    seq_len: int = 128


def _tokens_for(step: int, cfg: DataConfig, start_row: int,
                n_rows: int) -> np.ndarray:
    """Stateless token block [n_rows, seq_len+1] for global rows
    [start_row, start_row+n_rows) of batch `step`."""
    rows = np.arange(start_row, start_row + n_rows, dtype=np.uint64)[:, None]
    cols = np.arange(cfg.seq_len + 1, dtype=np.uint64)[None, :]
    with np.errstate(over="ignore"):  # modular uint64 mixing is intended
        x = (rows * np.uint64(6364136223846793005)
             + cols * np.uint64(1442695040888963407)
             + np.uint64(step) * np.uint64(2862933555777941757)
             + np.uint64(cfg.seed) * np.uint64(3202034522624059733))
    # splitmix-style scramble (modular)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(33))) * np.uint64(0xFF51AFD7ED558CCD)
        x = (x ^ (x >> np.uint64(33))) * np.uint64(0xC4CEB9FE1A85EC53)
        x = x ^ (x >> np.uint64(33))
    return (x % np.uint64(cfg.vocab_size)).astype(np.int32)


def synthetic_batch(step: int, cfg: DataConfig) -> Dict[str, np.ndarray]:
    """Host-global batch: inputs = block[:, :-1], targets = block[:, 1:]
    (next-token prediction packing)."""
    block = _tokens_for(step, cfg, 0, cfg.batch)
    return {"tokens": block[:, :-1], "targets": block[:, 1:]}


def sharded_batch(step: int, cfg: DataConfig, mesh,
                  batch_sharding) -> Dict[str, "torch.Tensor"]:
    """The global batch of `step` as DTensors placed by `batch_sharding`
    (name -> `repro_torch.sharding.NamedSharding`): every rank builds the
    same host batch and keeps its own rows, with no communication."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    out = {}
    for name, host_arr in synthetic_batch(step, cfg).items():
        shd = batch_sharding[name]
        out[name] = distribute_tensor(
            torch.from_numpy(np.ascontiguousarray(host_arr)).to(
                mesh.device_type), mesh, shd.placements, src_data_rank=None)
    return out


def iterator(cfg: DataConfig,
             start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield synthetic_batch(step, cfg)
        step += 1


def embed_stub_batch(step: int, arch, batch: int, seq: int,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """Precomputed-frontend stand-in for embed-stub configs (audio, VLM):
    deterministic pseudo-embeddings [batch, seq, d_model] * 0.02 in float32
    and token targets, the reference's arrays to the bit."""
    dcfg = DataConfig(seed=seed, vocab_size=arch.vocab_size, batch=batch,
                      seq_len=seq)
    toks = _tokens_for(step, dcfg, 0, batch)
    rng = np.random.RandomState((seed * 1_000_003 + step) % (2 ** 31))
    emb = rng.randn(batch, seq, arch.d_model).astype(np.float32) * 0.02
    return {"embeds": emb, "targets": toks[:, 1:][:, :seq]}
