"""Multi-pod dry run: trace every (arch x shape) cell on the production
meshes and extract memory, cost and collective figures.

Port of `repro.launch.dryrun`. The reference lowers and compiles each cell
on 256 or 512 forced host devices and reads XLA's `cost_analysis`,
`memory_analysis` and partitioned HLO. The port has no XLA. Its cell runs
in one process on a fake process group of 256 or 512 ranks
(`torch.testing._internal.distributed.fake_pg`: collectives return at
once), on a `DeviceMesh` of "cpu" over them. The model, optimizer state
and caches are built on `meta` (shapes and dtypes, no storage) and placed
as DTensors by the reference's specs, and ONE step (train, prefill or
decode, as the shape says) runs for rank 0 of the mesh:

  * FLOPs: `torch.utils.flop_counter.FlopCounterMode` over the step (this
    rank's local work: the per-partition figure);
  * bytes: every non-view op's tensor operands and results (XLA's "bytes
    accessed" rule), per partition;
  * collectives: the operand bytes of every `_c10d_functional` collective
    the step issues, by type, into `roofline.CollectiveStats` (the
    counterpart of the reference's HLO parse);
  * memory: argument and output bytes from the local shard shapes of the
    step's inputs and outputs; temp and alias bytes, which XLA alone
    gives, stay None (the reference's `getattr(..., None)` allows it).
    The weights a rank gathers at their use are such temporaries, so the
    figure does not show them: a "model" block for every weight the specs
    split on "model", the whole weight for the rest.

The kernels take their plain versions on `meta` (`repro_torch.PLAIN_DEVICES`).
Global FLOPs and bytes are the per-partition figures times the ranks,
each against the analytic model, the larger kept (both recorded), as the
reference does. The port's step splits every weight the specs shard on
"model" over the "model" ranks, as GSPMD splits the reference's
(`repro_torch.models.model`): the traced FLOPs are one rank's share of the
split step. What stays whole on every "model" rank is what the specs place
whole there (norms, routers, MLA's w_kv_a and latent projection, the
softmax of attention split by head_dim) and xLSTM (its config turns
tensor parallelism off).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape decode_32k --mesh single --out build/dryrun

Results are cached as JSON per cell (reruns skip). A cell that fails is
written with "status": "error" and its traceback, and the CLI exits 1.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import kernel_build
from repro_torch.configs import (SHAPES, get_config, input_specs,
                                 shape_applicable)
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.model import XLSTM_CELLS, build
from repro_torch.optim import adamw
from repro_torch.sharding import (batch_specs, cache_specs, distribute,
                                  distribute_model, to_named)
from repro_torch.train import init_state, make_train_step
from repro_torch.tree import leaves

#: the step's collectives, by the roofline's names
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

DEFAULT_OUT = str(kernel_build.BUILD_DIR.parent / "dryrun")


def _nbytes(t) -> int:
    if hasattr(t, "to_local"):
        t = t.to_local()
    return t.numel() * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


class StepCounter(TorchDispatchMode):
    """Bytes accessed by every non-view op and the operand bytes of every
    functional collective, as one step dispatches them."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.coll = rl.CollectiveStats(
            bytes_by_op={c: 0.0 for c in rl.COLLECTIVES},
            count_by_op={c: 0 for c in rl.COLLECTIVES})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.namespace == "_c10d_functional" and name in _COLLECTIVE_OPS:
            kind = _COLLECTIVE_OPS[name]
            self.coll.bytes_by_op[kind] += float(
                sum(_nbytes(t) for t in _tensors(args)))
            self.coll.count_by_op[kind] += 1
        elif func.namespace == "aten" and not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        return out


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A fake process group of `n_ranks` in this process, rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(multi_pod: bool, mesh_shape: Optional[Tuple[int, ...]]):
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    names = ("pod", "data", "model")[-len(mesh_shape):]
    return make_mesh(mesh_shape, names, "cpu")


def _local_bytes(tree) -> int:
    return sum(_nbytes(t) for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def trace_cell(arch_name: str, shape_name: str, multi_pod: bool,
               overrides: Optional[dict] = None,
               mesh_shape: Optional[Tuple[int, ...]] = None):
    """Trace one cell's step; returns (figures, meta), figures None for a
    shape the arch does not run. `mesh_shape` replaces the production mesh
    (a test runs a reduced cell on a few fake ranks)."""
    cfg = get_config(arch_name)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return None, {"skipped": why}
    n_chips = 1
    for d in (mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))):
        n_chips *= d

    with fake_world(n_chips):
        mesh = _mesh(multi_pod, mesh_shape)
        model = build(cfg, device="meta")
        params_bytes = sum(p.numel() * p.element_size()
                           for p in model.parameters())
        params_abs = model.params()      # before the DTensors replace them
        distribute_model(model, cfg, mesh)
        specs_in = input_specs(cfg, shape)
        batch = distribute(specs_in, to_named(
            mesh, batch_specs(cfg, specs_in, mesh)))
        flops = FlopCounterMode(display=False)
        counter = StepCounter()
        t0 = time.monotonic()
        if shape.kind == "train":
            opt_cfg = adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype)
            state = init_state(model, opt_cfg)
            args_bytes = _local_bytes(state) + _local_bytes(batch)
            step = make_train_step(model, opt_cfg)
            with flops, counter:
                new_state, _ = step(state, batch)
            out_bytes = _local_bytes(new_state)
            opt_itemsize = 2 if cfg.opt_state_dtype == "bfloat16" else 4
            opt_bytes = sum(p.numel() * opt_itemsize
                            for p in model.parameters())
            state_bytes = params_bytes + 2 * opt_bytes
            cache_bytes = 0.0
        else:
            caches = model.init_caches(shape.global_batch, shape.seq_len)
            cache_bytes = float(sum(t.numel() * t.element_size()
                                    for t in leaves(caches)))
            c_named = to_named(mesh, cache_specs(cfg, caches, mesh))
            state_bytes = params_bytes
            if shape.kind == "prefill":
                args_bytes = _local_bytes(model.params()) + \
                    _local_bytes(batch)
                with flops, counter:
                    new_caches, logits = model.prefill(
                        batch, max_len=shape.seq_len)
            else:
                caches = distribute(caches, c_named)
                args_bytes = _local_bytes(model.params()) + \
                    _local_bytes(caches) + _local_bytes(batch)
                with flops, counter:
                    new_caches, logits = model.decode_step(caches, batch)
            # outputs placed as the reference's out_shardings: the caches
            # by their specs (this rank's shard), the logits as computed
            out_bytes = _local_bytes(_shards(new_caches, c_named, mesh,
                                             model.kinds)) + _nbytes(logits)
        trace_s = time.monotonic() - t0

    meta = {
        "arch": arch_name, "shape": shape_name,
        "mesh": ("x".join(str(d) for d in mesh_shape) if mesh_shape else
                 "2x16x16" if multi_pod else "16x16"),
        "n_chips": n_chips,
        "compile_seconds": trace_s,
        "model_flops": rl.model_flops(cfg, params_abs, shape),
        "analytic_flops": rl.analytic_flops(cfg, shape),
        "analytic_bytes": rl.analytic_bytes(cfg, shape, float(params_bytes),
                                            float(cache_bytes)),
        "params_bytes": float(params_bytes),
        "state_bytes": float(state_bytes),
        "cache_bytes": float(cache_bytes),
    }
    figures = {"flops_pp": float(flops.get_total_flops()),
               "bytes_pp": float(counter.bytes), "coll": counter.coll,
               "argument_bytes": args_bytes, "output_bytes": out_bytes}
    return figures, meta


def _shards(caches, named, mesh, kinds):
    """This rank's shard of each new cache under its spec: the step
    returns it (this rank's rows and "model" block of the feature dim),
    but for the xLSTM states, which it returns whole in their features."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.sharding import rules

    flat = {}
    rules.map_with_path(lambda p, s: flat.__setitem__(p, s), named)

    def one(path, t):
        if kinds[int(path[0])] not in XLSTM_CELLS:
            return t
        full = DTensor.from_local(t, mesh, rules.batch_placements(mesh)
                                  if _dp_sharded(flat[path]) else
                                  [Replicate()] * mesh.ndim,
                                  run_check=False)
        return full.redistribute(mesh, flat[path].placements).to_local()
    return rules.map_with_path(one, caches)


def _dp_sharded(named) -> bool:
    return bool(named.spec) and named.spec[0] is not None


def analyze(figures: dict, meta: dict) -> dict:
    n_chips = meta["n_chips"]
    coll = figures["coll"]
    # the traced step counts each layer once, as XLA's cost_analysis counts
    # a scan body once; take the max of the traced and analytic models per
    # term (both recorded), as the reference does
    device = rl.DEFAULT_DEVICE
    terms = rl.RooflineTerms(
        flops_global=max(figures["flops_pp"] * n_chips,
                         meta["analytic_flops"]),
        bytes_global=max(figures["bytes_pp"] * n_chips,
                         meta["analytic_bytes"]),
        collective_bytes_per_chip=coll.total_bytes,
        n_chips=n_chips,
        model_flops=meta["model_flops"],
        device=device,
    )
    return {
        **meta,
        "device": device.to_dict(),
        "memory": {
            "argument_bytes": figures["argument_bytes"],
            "output_bytes": figures["output_bytes"],
            "temp_bytes": None,
            "alias_bytes": None,
        },
        "cost": {"flops_per_partition": figures["flops_pp"],
                 "bytes_per_partition": figures["bytes_pp"]},
        "collectives": {"bytes_by_op": coll.bytes_by_op,
                        "count_by_op": coll.count_by_op},
        "roofline": terms.to_dict(),
    }


def run_cell(arch: str, shape: str, mesh: str, out_dir: str,
             force: bool = False, overrides: Optional[dict] = None,
             mesh_shape: Optional[Tuple[int, ...]] = None) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{shape}__{mesh}"
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    try:
        figures, meta = trace_cell(arch, shape, mesh == "multi",
                                   overrides=overrides, mesh_shape=mesh_shape)
        if figures is None:
            result = {"arch": arch, "shape": shape, "mesh": mesh, **meta}
        else:
            result = analyze(figures, meta)
            result["status"] = "ok"
    except Exception as e:  # a failure here is a bug in the system
        result = {"arch": arch, "shape": shape, "mesh": mesh,
                  "status": "error", "error": repr(e),
                  "traceback": traceback.format_exc()}
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    res = run_cell(args.arch, args.shape, args.mesh, args.out, args.force)
    status = res.get("status", "skipped" if "skipped" in res else "?")
    print(json.dumps(res.get("roofline", res), indent=1))
    if status == "error":
        print(res.get("traceback", ""), file=sys.stderr)
        return 1
    if "memory" in res:
        per_dev = sum(v for v in res["memory"].values() if v)
        print(f"[{args.arch} x {args.shape} x {args.mesh}] traced OK in "
              f"{res['compile_seconds']:.2f} s; "
              f"~{per_dev/2**30:.2f} GiB/device accounted; "
              f"bottleneck={res['roofline']['bottleneck']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
