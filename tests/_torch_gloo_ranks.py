"""Multi-rank cases of the port's mesh path, on CPU `gloo` ranks.

Run by `tests/test_torch_sharding.py` in a child process, so that no
pytest worker holds a process group:

  python tests/_torch_gloo_ranks.py <dir>

`<dir>` holds the reference's numbers (`inputs.npz`, `inputs.json`), which
the test computed with the JAX package; this script imports torch, numpy
and `repro_torch` only. It spawns 8 ranks joined by a `FileStore`, runs
every case on each, and rank 0 writes `<dir>/results.json`: per case
{"ok": bool, ...measured values..., "error": traceback}. The meshes are
4x2 (the train steps, prefill and decode; elastic restore onto 2x4 and
8x1), 1x8 (train steps with attention split by head_dim) and (1, 8),
(2, 4), (4, 2) (expert parallelism, and the tiled accesses over 1, 2 and
4 "data" ranks).
"""
import json
import os
import sys
import tempfile
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

WORLD = 8


def _ledger(led) -> dict:
    d = {k: v for k, v in vars(led).items() if k != "enabled"}
    d["bank_accesses"] = {str(k): v for k, v in
                          sorted(led.bank_accesses.items())}
    d["per_device"] = {str(k): v for k, v in sorted(led.per_device().items())}
    return d


def case_train_4x2(ctx):
    """Two sharded train steps of reduced llama3.2-1b from the reference's
    weights, 8 x 64 tokens (64 positions: the activation hint shards the
    sequence over "model" between layers): loss and grad norm each step,
    and the tensor-parallel regions each step ran."""
    return _train_steps(ctx, "llama3.2-1b", "train")


def case_train_moe_4x2(ctx):
    """The same for reduced deepseek-v2-lite-16b (MLA, MoE): its MoE
    layers gather the batch over the dp axes, so routing, capacity and the
    aux loss are the whole batch's, as the reference's."""
    return _train_steps(ctx, "deepseek-v2-lite-16b", "moe_train")


#: the tensor-parallel cases: (arch, key of the reference's numbers, mesh)
#: on 4x2, and on 1x8 where 4 heads on 8 "model" ranks split head_dim
TP_TRAIN = [("gemma-2b", "gemma_train", (4, 2)),
            ("recurrentgemma-9b", "rg_train", (4, 2)),
            ("grok-1-314b", "grok_train", (4, 2)),
            ("llama3.2-1b", "train", (1, 8)),
            ("deepseek-v2-lite-16b", "moe_train", (1, 8))]
TP_SERVE = [("llama3.2-1b", "train"), ("deepseek-v2-lite-16b", "moe_train"),
            ("recurrentgemma-9b", "rg_train")]


def _model_sharded(t) -> bool:
    from repro_torch.sharding import rules

    return rules.is_dtensor(t) and any(
        a == "model" and type(p).__name__ == "Shard"
        for a, p in zip(rules.axis_names(t.device_mesh), t.placements))


class _Whole:
    """Counts what a rank gathers whole while it is in scope: the
    parameters `param_specs` split over "model" that pass through
    `rules.gather_param` (by name), and the cache trees a layer joins over
    "model" (`rules.tree_join_blocks`) or gathers from DTensors
    (`rules.tree_local_batch`)."""

    def __init__(self, model):
        self.names = {id(p): n for n, p in model.named_parameters()}
        self.params, self.caches = set(), 0

    def __enter__(self):
        from repro_torch.sharding import rules

        self.saved = (rules.gather_param, rules.tree_join_blocks,
                      rules.tree_local_batch)
        gather, join, local = self.saved

        def gather_param(t, *a, **k):
            if _model_sharded(t):
                self.params.add(self.names.get(id(t), "?"))
            return gather(t, *a, **k)

        def tree_join_blocks(tree, *a):
            self.caches += 1
            return join(tree, *a)

        def tree_local_batch(tree):
            if tree is not None and any(_model_sharded(t)
                                        for t in tree.values()):
                self.caches += 1
            return local(tree)
        (rules.gather_param, rules.tree_join_blocks,
         rules.tree_local_batch) = (gather_param, tree_join_blocks,
                                    tree_local_batch)
        return self

    def __exit__(self, *exc):
        from repro_torch.sharding import rules

        (rules.gather_param, rules.tree_join_blocks,
         rules.tree_local_batch) = self.saved

    def record(self) -> dict:
        return {"params_whole": sorted(self.params),
                "caches_whole": self.caches}


def _reference_model(ctx, arch, key, seed: int = 0):
    """Reduced `arch` built on the CPU with the reference's weights."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import build
    from repro_torch.tree import walk

    cfg = get_config(arch).reduced()
    model = build(cfg, device="cpu", seed=seed)
    with torch.no_grad():
        for path, leaf in walk(model.params()):
            leaf.copy_(torch.from_numpy(
                ctx["npz"][key + "::" + "::".join(path)]))
    return cfg, model


def _train_steps(ctx, arch, key, shape=(4, 2)):
    from repro_torch.data import DataConfig, sharded_batch, synthetic_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding import batch_specs, distribute_model, to_named
    from repro_torch.sharding import rules
    from repro_torch.train import init_state, make_train_step

    cfg, model = _reference_model(ctx, arch, key)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    distribute_model(model, cfg, mesh)
    n_dtensor = sum(type(p).__name__ == "DTensor" for p in model.parameters())
    opt = AdamWConfig(lr=1e-3)
    state = init_state(model, opt)
    step = make_train_step(model, opt)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, batch=8, seq_len=64)
    regions = []                  # the tensor-parallel regions' exits
    exit_ = rules.tp_exit

    def counted(y, mesh_):
        regions[-1] += 1
        return exit_(y, mesh_)
    rules.tp_exit = counted
    out = {"loss": [], "grad_norm": [], "n_dtensor": n_dtensor,
           "tp_regions": regions,
           "n_params": len(list(model.parameters())),
           "moment_dtensor": type(next(
               m for m in state["opt"]["m"]["layers"] if "attn" in m)
               ["attn"]["wq"]).__name__}
    try:
        with _Whole(model) as whole:
            for s in range(2):
                host = synthetic_batch(s, dcfg)
                batch = sharded_batch(s, dcfg, mesh, to_named(
                    mesh, batch_specs(cfg, host, mesh)))
                regions.append(0)
                state, m = step(state, batch)
                out["loss"].append(float(m["loss"]))
                out["grad_norm"].append(float(m["grad_norm"]))
    finally:
        rules.tp_exit = exit_
    return {**out, **whole.record()}


def case_tp_train(ctx):
    """Two sharded train steps of each `TP_TRAIN` config from the
    reference's weights (8 x 64 tokens): the whole step tensor-parallel
    over "model" (the vocab-parallel embedding and CE, attention by head
    or by head_dim, MLA, the RG-LRU block by channel, MoE experts by their
    hidden dim): losses, grad norms, regions, and what was gathered
    whole."""
    return {f"{key}_{a}x{b}": _train_steps(ctx, arch, key, (a, b))
            for arch, key, (a, b) in TP_TRAIN}


def case_tp_serve(ctx):
    """A sharded prefill of 12 positions and 4 greedy-fed decode steps of
    each `TP_SERVE` config on 4x2, 8 rows from the reference's weights:
    every step's logits (the dp ranks' rows joined), the cache leaves'
    local shapes, and what was gathered whole."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import (batch_specs, distribute,
                                      distribute_model, rules, to_named)

    npz = ctx["npz"]
    out = {}
    for arch, key in TP_SERVE:
        cfg, model = _reference_model(ctx, arch, key)
        mesh = make_mesh((4, 2), ("data", "model"), "cpu")
        distribute_model(model, cfg, mesh)
        toks = torch.from_numpy(npz["serve_tokens"]).long()

        def placed(b):
            return distribute(b, to_named(mesh, batch_specs(cfg, b, mesh)))

        def rows(t):
            return rules.from_local_batch(t, mesh).full_tensor()
        with _Whole(model) as whole:
            caches, logits = model.prefill(placed({"tokens": toks[:, :12]}),
                                           max_len=16)
            got = [rows(logits)]
            for t in range(12, 16):
                caches, logits = model.decode_step(caches, placed({
                    "tokens": toks[:, t:t + 1],
                    "positions": torch.full((8,), t, dtype=torch.int32)}))
                got.append(rows(logits))
        want = npz[key + "_serve_logits"]
        out[key] = {"err": [float(np.max(np.abs(g.numpy() - w)))
                            for g, w in zip(got, want)],
                    "cache_shapes": {f"{i}/{k}": list(t.shape)
                                     for i, c in enumerate(caches)
                                     for k, t in c.items()},
                    **whole.record()}
    return out


def case_elastic(ctx):
    """Save a 4x2-placed state, restore it onto 2x4 and 8x1: every leaf's
    whole value bit-identical."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import restore_on_mesh
    from repro_torch.sharding import distribute_model
    from repro_torch.train import init_state
    from repro_torch.tree import leaves, tree_map

    cfg = get_config("llama3.2-1b").reduced()
    model = build(cfg, device="cpu", seed=3)
    mesh_a = make_mesh((4, 2), ("data", "model"), "cpu")
    distribute_model(model, cfg, mesh_a)
    state = init_state(model, AdamWConfig())
    with torch.no_grad():          # moments that are not all zero
        for m, p in zip(leaves(state["opt"]["m"]), leaves(state["params"])):
            m.copy_(p * 0.5)
    whole = [t.full_tensor() if hasattr(t, "full_tensor") else t
             for t in leaves(state)]
    ckpt = CheckpointManager(ctx["ckpt_dir"])
    ckpt.save(7, state, blocking=True)
    abstract = tree_map(lambda t: torch.zeros(tuple(t.shape), dtype=t.dtype),
                        state)
    out = {}
    for shape in ((2, 4), (8, 1)):
        mesh_b = make_mesh(shape, ("data", "model"), "cpu")
        restored = restore_on_mesh(ckpt, 7, abstract, cfg, mesh_b)
        got = leaves(restored)
        out[f"{shape[0]}x{shape[1]}"] = {
            "leaves": len(got),
            "dtensors": sum(hasattr(t, "device_mesh") and
                            t.device_mesh is mesh_b for t in got),
            "equal": all(torch.equal(w, g.full_tensor()) for w, g in
                         zip(whole, got)),
        }
    # the supervisor's in-place restore into a live state's DTensors
    with torch.no_grad():
        for t in leaves(state):
            t.zero_()
    ckpt.restore(7, state)
    out["in_place"] = all(
        torch.equal(w, t.full_tensor() if hasattr(t, "full_tensor") else t)
        for w, t in zip(whole, leaves(state)))
    return out


def case_moe_ep(ctx):
    """`moe_apply_ep` on 2x4, 1x8 and 4x2: 4, 8 and 2 expert shards, from
    plain weights and from DTensor weights with the experts on "model"
    (the parameters it gathers whole recorded)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.moe_ep import moe_apply_ep
    from repro_torch.sharding import P, distribute, rules, to_named

    cfg = get_config("grok-1-314b").reduced()
    cfg = dataclasses.replace(
        cfg, d_model=64,
        moe=dataclasses.replace(cfg.moe, n_experts=8, top_k=2,
                                d_ff_expert=32, n_shared=0,
                                capacity_factor=8.0))
    npz = ctx["npz"]
    p = {k: torch.from_numpy(npz["moe::" + k])
         for k in ("router", "w_in", "w_gate", "w_out")}
    out = {}
    for shape in ((2, 4), (1, 8), (4, 2)):
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        y = moe_apply_ep(p, cfg, torch.from_numpy(npz["moe_x"]), mesh)
        # the same weights placed as param_specs places them ("ep"):
        # experts on "model", d_model on "data"
        specs = {"router": P("data", None), "w_in": P("model", "data", None),
                 "w_gate": P("model", "data", None),
                 "w_out": P("model", None, "data")}
        pd = distribute(p, to_named(mesh, specs))
        gathered = []
        whole = rules.gather_param

        def counted(t, *a, **k):
            gathered.append(tuple(t.shape))
            return whole(t, *a, **k)
        rules.gather_param = counted
        try:
            yd = moe_apply_ep(pd, cfg, torch.from_numpy(npz["moe_x"]), mesh)
        finally:
            rules.gather_param = whole
        out[f"{shape[0]}x{shape[1]}"] = {
            "err": float(np.max(np.abs(y.numpy() - npz["moe_y"]))),
            "shape": list(y.shape),
            "err_dtensor": float(np.max(np.abs(yd.numpy() - npz["moe_y"]))),
            "gathered_whole": [list(g) for g in gathered]}
    return out


def _mesh_for(n_data):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh((n_data, WORLD // n_data), ("data", "model"), "cpu")


def case_cim(ctx):
    """execute_sharded, multiply(mesh=) and lower(mesh=) over 1, 2 and 4
    "data" ranks: bits and ledgers."""
    import torch

    from repro_torch import cim
    from repro_torch.cim import PlanePack, dispatch
    from repro_torch.cim.accounting import LEDGER
    from repro_torch.cim.lower import lower

    npz, meta = ctx["npz"], ctx["json"]
    out = {}
    for n_data in (1, 2, 4):
        mesh = _mesh_for(n_data)
        r = {}
        # execute_sharded: tests/test_cim_array.py's setup
        pa = PlanePack.pack(torch.from_numpy(npz["tile_a"]), 8)
        pb = PlanePack.pack(torch.from_numpy(npz["tile_b"]), 8)
        spec = cim.ArraySpec(banks=2, subarrays=1, rows=64, bitline_words=32)
        LEDGER.reset()
        o = dispatch.execute_sharded(pa, pb, ("sub", "lt"), mesh, spec=spec,
                                     backend="torch-boolean")
        r["tile_sub"] = bool(np.array_equal(o["sub"].unpack().numpy(),
                                            npz["tile_sub"]))
        r["tile_lt"] = bool(np.array_equal(o["lt"].unpack().numpy(),
                                           npz["tile_lt"]))
        r["tile_planes"] = bool(np.array_equal(
            o["sub"].planes.numpy(), npz["tile_sub_planes"]))
        r["tile_ledger"] = _ledger(LEDGER) == meta[f"tile_ledger_{n_data}"]
        r["tile_per_device"] = _ledger(LEDGER)["per_device"]
        # cim.multiply(mesh=): tests/test_cim_program.py:241
        spec2 = cim.ArraySpec(banks=2, subarrays=1, rows=256,
                              bitline_words=32)
        LEDGER.reset()
        prod = cim.multiply(PlanePack.pack(torch.from_numpy(npz["mul_x"]), 8),
                            PlanePack.pack(torch.from_numpy(npz["mul_y"]), 8),
                            backend="torch-boolean", spec=spec2, mesh=mesh)
        r["mul_bits"] = bool(np.array_equal(prod.unpack().numpy(),
                                            npz["mul_x"] * npz["mul_y"]))
        r["mul_accesses"] = LEDGER.accesses
        # lower(mesh=)
        LEDGER.reset()
        dispatch.clear_schedule_cache()

        def fn(a, b):
            return (a + b) * b
        lf = lower(fn, backend="torch-boolean", spec=spec2, mesh=mesh)
        a = torch.from_numpy(npz["low_a"])
        b = torch.from_numpy(npz["low_b"])
        got = lf(a, b)
        r["lower_out"] = bool(np.array_equal(got.numpy(), npz["low_out"]))
        r["lower_accesses"] = LEDGER.accesses
        r["lower_bank_total"] = sum(LEDGER.bank_accesses.values())
        out[str(n_data)] = r
    return out


def case_hints(ctx):
    """The activation hints redistribute a DTensor on a mesh in scope and
    pass anything else through."""
    import torch
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.models.layers import (hint_activation_sharding,
                                           hint_batch_sharding)
    from repro_torch.sharding import rules

    mesh = _mesh_for(4)
    x = torch.arange(8 * 64 * 4, dtype=torch.float32).reshape(8, 64, 4)
    d = rules.from_local_batch(rules.local_rows(x, mesh), mesh)
    out = {"identity_off_mesh": hint_activation_sharding(d) is d}
    with rules.use_mesh(mesh):
        a = hint_activation_sharding(d)
        out["activation"] = [repr(p) for p in a.placements]
        out["activation_equal"] = bool(torch.equal(a.full_tensor(), x))
        short = rules.from_local_batch(rules.local_rows(x[:, :8], mesh), mesh)
        out["short"] = [repr(p) for p in
                        hint_activation_sharding(short).placements]
        out["batch"] = [repr(p) for p in hint_batch_sharding(a).placements]
        out["plain"] = hint_batch_sharding(x) is x
        out["ok_types"] = isinstance(a, DTensor) and \
            a.placements == (Shard(0), Shard(1))
    return out


CASES = [case_train_4x2, case_train_moe_4x2, case_tp_train, case_tp_serve,
         case_elastic, case_moe_ep, case_cim, case_hints]


def _rank(rank: int, work: str, store: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    with np.load(os.path.join(work, "inputs.npz")) as z:
        npz = {k: z[k] for k in z.files}
    with open(os.path.join(work, "inputs.json")) as f:
        meta = json.load(f)
    ctx = {"npz": npz, "json": meta, "ckpt_dir": os.path.join(work, "ckpt")}
    results = {}
    for case in CASES:
        name = case.__name__[len("case_"):]
        try:
            results[name] = {"ok": True, **case(ctx)}
        except Exception:           # recorded, and the test of it fails
            results[name] = {"ok": False, "error": traceback.format_exc()}
        dist.barrier()
    if rank == 0:
        with open(os.path.join(work, "results.json"), "w") as f:
            json.dump(results, f, indent=1)
    dist.destroy_process_group()


def main() -> None:
    import torch.multiprocessing as mp

    work = sys.argv[1]
    store = os.path.join(tempfile.mkdtemp(dir=work), "store")
    mp.spawn(_rank, args=(work, store), nprocs=WORLD)


if __name__ == "__main__":
    main()
