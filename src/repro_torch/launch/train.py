"""End-to-end training driver with fault tolerance.

Port of `repro.launch.train`. It trains every config of the registry
(dense, MoE and MLA, embed stub, the RG-LRU hybrid, xLSTM) on one card;
`--arch` defaults to llama3.2-1b, as the reference's does:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --preset full --device cuda --steps 4 --batch 2 --seq 2048

and its CPU rehearsal with `--preset reduced --device cpu`. Presets:
reduced (CPU-test size), 100m (~100M-parameter variant), full (the
published config). Weights are random from `--seed`; the data is the
deterministic synthetic stream of `repro_torch.data` (embed-stub configs
take `embed_stub_batch`: pseudo-embeddings and the same token targets).
The loop runs under
the `Supervisor`: async checkpoints every `--ckpt-every` steps, NaN
sentinel, restore on failure. At full width one checkpoint is about 40 GB
of npz (f32 params and both Adam moments): keep `--ckpt-every` above
`--steps` on the card.

Launched by `torchrun` (which sets WORLD_SIZE), every rank joins a
process group (NCCL on cards, one card a rank; gloo on CPUs) and trains
under `make_smoke_mesh()` over its ranks, as the reference trains under
its smoke mesh: parameters and optimizer state are DTensors placed by the
reference's `state_specs`, the batch by `batch_specs`
(`data.sharded_batch`), and each rank runs its own rows, gathering each
parameter at its use (`repro_torch.models.model`):

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch llama3.2-1b \
      --preset full --device cuda --steps 4 --batch 2 --seq 2048

With a single process it trains on one device with no process group and
no mesh. There is no `jax.jit` and no donation. Each
step is timed between two device synchronizes, so its wall ms covers the
device's work as well as the host's. Rank 0 prints. It
prints every `--log-every`-th step's loss, ce, grad norm and wall ms; at
the end the steady tokens/s (the first step excluded), the flash, RG-LRU
and sLSTM kernels' launches and the peak device memory.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import kernel_build, resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import preset_config
from repro_torch.data import (DataConfig, embed_stub_batch, sharded_batch,
                              synthetic_batch)
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import rglru, slstm
from repro_torch.models.model import Model, build
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.runtime import Supervisor, SupervisorConfig
from repro_torch.sharding import batch_specs, distribute_model, to_named
from repro_torch.train import init_state, make_train_step

#: checkpoints default to a directory under the checkout's build/
DEFAULT_CKPT_DIR = str(kernel_build.BUILD_DIR.parent / "repro_torch_ckpt")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--preset", default="reduced",
                    choices=("reduced", "100m", "full"))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    return ap.parse_args(argv)


def main(argv=None, model: Optional[Model] = None) -> Dict[str, Any]:
    """Train; returns the run's record (per-step metrics and wall ms,
    restarts, steady tokens/s, flash launches, peak device memory)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    mesh = None
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        # torchrun: one rank a card (or a CPU process), all in one mesh
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    if dist.is_initialized():
        mesh = make_smoke_mesh(device_type=dev.type)
    try:
        return _train(args, dev, mesh, model)
    finally:
        if mesh is not None and "WORLD_SIZE" in os.environ:
            dist.destroy_process_group()


def _train(args, dev: torch.device, mesh, model: Optional[Model]):
    lead = mesh is None or dist.get_rank() == 0
    cfg = preset_config(args.arch, args.preset)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t_init = time.perf_counter()
    if model is None:
        model = build(cfg, device=dev, seed=args.seed)
    if mesh is not None:
        distribute_model(model, cfg, mesh)
    opt_cfg = AdamWConfig(lr=args.lr, state_dtype=cfg.opt_state_dtype)
    sched = cosine_schedule(args.lr, warmup=max(args.steps // 20, 5),
                            total=args.steps)
    state = init_state(model, opt_cfg, compress_grads=args.compress_grads)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, batch=args.batch,
                      seq_len=args.seq)
    n_params = sum(p.numel() for p in model.parameters())
    where = dev if mesh is None else \
        f"mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} of {dev.type}"
    if lead:
        print(f"train: {cfg.name} on {where}: {n_params} parameters, "
              f"{len(model.kinds)} layers, batch {args.batch} x {args.seq}, "
              f"{cfg.microbatches} microbatches, remat {cfg.remat}, "
              f"{cfg.dtype} compute; init "
              f"{time.perf_counter() - t_init:.2f} s", flush=True)

    def make_batch(step: int):
        if mesh is not None and not cfg.embed_stub:
            host = synthetic_batch(step, dcfg)
            return sharded_batch(step, dcfg, mesh, to_named(
                mesh, batch_specs(cfg, host, mesh)))
        host = (embed_stub_batch(step, cfg, args.batch, args.seq)
                if cfg.embed_stub else synthetic_batch(step, dcfg))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        if mesh is not None:
            from repro_torch.sharding import distribute

            batch = distribute(batch, to_named(
                mesh, batch_specs(cfg, batch, mesh)))
        return batch

    step_fn = make_train_step(model, opt_cfg, lr_schedule=sched,
                              compress_grads=args.compress_grads)
    records = []

    def logging_step(state, batch):
        if on_card:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        if on_card:
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        m = {k: float(out[1][k]) for k in ("loss", "ce", "aux", "grad_norm",
                                            "lr")}
        records.append({"step": int(state["step"]), **m, "ms": ms})
        if lead and len(records) % args.log_every == 0:
            print(f"step {int(out[0]['step']):5d}  loss {m['loss']:.4f}  ce "
                  f"{m['ce']:.4f}  gnorm {m['grad_norm']:.4f}  lr "
                  f"{m['lr']:.3e}  {ms:.1f} ms", flush=True)
        return out

    ckpt = CheckpointManager(args.ckpt_dir)
    sup = Supervisor(logging_step, make_batch, ckpt,
                     SupervisorConfig(ckpt_every=args.ckpt_every))
    counters = (flash.launches, rglru.launches, slstm.launches)
    launches0 = [f() for f in counters]
    t0 = time.perf_counter()
    state, metrics = sup.run(state, args.steps)
    wall_s = time.perf_counter() - t0
    flash_launches, rglru_launches, slstm_launches = (
        f() - n for f, n in zip(counters, launches0))
    steady = records[1:]
    tok_s = (len(steady) * args.batch * args.seq
             / (sum(r["ms"] for r in steady) / 1e3)) if steady else None
    peak_gib = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                if on_card else None)
    if lead:
        print(f"done: {args.steps} steps in {wall_s:.2f} s; final loss "
              f"{float(metrics['loss']):.4f}; steady "
              + (f"{tok_s:.1f} tokens/s" if tok_s else "tokens/s not measured "
                 "(one step)")
              + f"; {flash_launches} flash launches; {rglru_launches} rglru "
              f"launches; {slstm_launches} slstm launches; peak device memory "
              + (f"{peak_gib:.2f} GiB" if on_card else "not measured (CPU)"),
              flush=True)
    return {"steps": args.steps, "records": records,
            "restarts": len(sup.events), "tok_s_steady": tok_s,
            "flash_launches": flash_launches,
            "rglru_launches": rglru_launches,
            "slstm_launches": slstm_launches, "peak_gib": peak_gib,
            "wall_s": wall_s, "n_params": n_params,
            "final_loss": float(metrics["loss"])}


if __name__ == "__main__":
    main()
