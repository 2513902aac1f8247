"""Logical sharding rules: param/cache/batch trees -> PartitionSpec trees,
and their DTensor placements.

Port of `repro.sharding.rules`. Mesh axes: ("data", "model") single-pod,
("pod", "data", "model") multi-pod. A mesh is a `DeviceMesh`
(`repro_torch.launch.mesh`) or any object with `shape` (axis name -> size)
and `axis_names`: the rules read nothing else, so they run on the
production meshes' structure alone.

Conventions (DESIGN.md §6):
  * params are 2-D sharded: FSDP dim -> "data", tensor dim -> "model"
    (256-way within a pod); params are replicated across "pod" (optimizer
    states inherit param specs 1:1).
  * attention head dims: shard the head axis on "model" when divisible by the
    axis size, else the head_dim axis (qwen's 40 heads, MQA's single kv head),
    else replicate.
  * MoE experts: expert dim -> "model" when divisible ("ep"), else TP within
    the expert FFN ("tp": grok's 8 experts on a 16-wide axis).
  * caches: batch -> dp axes when divisible (long_500k's batch=1 falls back
    to replicated batch + "model"-sharded feature dims).

Every rule is checked against the actual leaf shape and mesh axis sizes
(`_fit`) and non-divisible axes are dropped dim by dim. The port's
parameter tree holds one dict per layer (`layers/<i>/...`) where the
reference stacks each pattern position under `groups`, so a port leaf's
spec is the reference's without the stacked leading `None`.

`to_named` maps a spec tree to `NamedSharding`s, whose `placements` are
the DTensor placements of the spec (`Shard(dim)` on each mesh dimension
named by the spec, `Replicate()` on the rest); `distribute` places a tree
of tensors with them. The dp helpers below (`batch_placements`,
`gather_param`, `gather_batch`, `use_mesh`) are what the port's sharded
train step and dry run use at their gather points.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig


class P(tuple):
    """A PartitionSpec: one entry per dim, each None, an axis name or a
    tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, for a DeviceMesh or a structure-only mesh."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), (int(n) for n in mesh.shape)))


def _dp_axes(mesh):
    return ("pod", "data") if "pod" in axis_names(mesh) else "data"


def _axes_size(mesh, entry) -> int:
    sizes = axis_sizes(mesh)
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        n = 1
        for a in entry:
            n *= sizes[a]
        return n
    return sizes[entry]


def _fit(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """Drop (dim-by-dim) any mesh axis that does not divide the dim size."""
    fitted = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            fitted.append(None)
        elif dim % _axes_size(mesh, entry) == 0:
            fitted.append(entry)
        else:
            fitted.append(None)
    return P(*fitted)


def _head_axis(cfg: ArchConfig, n_heads: int, mesh):
    """('model' on heads) | ('model' on head_dim) | replicated."""
    m = axis_sizes(mesh)["model"]
    if n_heads % m == 0:
        return "heads"
    if cfg.head_dim % m == 0:
        return "head_dim"
    return "none"


def _rule(path: str, ndim: int, cfg: ArchConfig, mesh) -> P:
    """Base (unstacked) PartitionSpec for a param leaf."""
    ep = cfg.moe is not None and cfg.expert_sharding == "ep" \
        and cfg.moe.n_experts % axis_sizes(mesh)["model"] == 0

    def ends(*names):
        return any(path.endswith(n) for n in names)

    q_mode = _head_axis(cfg, cfg.n_heads, mesh)
    kv_mode = _head_axis(cfg, cfg.n_kv_heads, mesh)

    # ---- embeddings / head
    if ends("embed/table"):
        return P("model", "data")
    if ends("lm_head/w"):
        return P("data", "model")

    # ---- attention (GQA + MLA)
    if ends("attn/wq"):
        return {"heads": P("data", "model", None),
                "head_dim": P("data", None, "model"),
                "none": P("data", None, None)}[q_mode]
    if ends("attn/wk", "attn/wv"):
        return {"heads": P("data", "model", None),
                "head_dim": P("data", None, "model"),
                "none": P("data", None, None)}[kv_mode]
    if ends("attn/wo"):
        return {"heads": P("model", None, "data"),
                "head_dim": P(None, "model", "data"),
                "none": P(None, None, "data")}[q_mode]
    if ends("attn/w_kv_a"):
        return P("data", None)
    if ends("attn/w_uk", "attn/w_uv"):
        return {"heads": P(None, "model", None),
                "head_dim": P("model", None, None),
                "none": P(None, None, None)}[q_mode]

    # ---- MoE
    if ends("mlp/router"):
        return P("data", None)
    if ends("mlp/w_in", "mlp/w_gate") and ndim == 3:
        return P("model", "data", None) if ep else P(None, "data", "model")
    if ends("mlp/w_out") and ndim == 3:
        return P("model", None, "data") if ep else P(None, "model", "data")
    if ends("mlp/shared_in", "mlp/shared_gate"):
        return P("data", "model")
    if ends("mlp/shared_out"):
        return P("model", "data")

    # ---- dense MLP
    if ends("mlp/w_in", "mlp/w_gate"):
        return P("data", "model")
    if ends("mlp/w_out"):
        return P("model", "data")

    # ---- RG-LRU block
    if ends("rec/w_x", "rec/w_gate"):
        return P("data", "model")
    if ends("rec/w_r", "rec/w_i"):
        return P("model", None)
    if ends("rec/conv_w"):
        return P(None, "model")
    if ends("rec/w_out"):
        return P("model", "data")

    # ---- xLSTM
    if ends("cell/w_up"):
        return P("data", "model")
    if ends("cell/w_qkv"):
        return P("model", None, None, None)
    if ends("cell/w_ifo"):
        return P("model", None, None)
    if ends("cell/w_down"):
        return P("model", "data")
    if ends("cell/w_gates", "cell/r_gates"):
        return P("data", None, "model")
    if ends("cell/ffn_in", "cell/ffn_gate"):
        return P("data", "model")
    if ends("cell/ffn_out"):
        return P("model", "data")

    # ---- norms, biases, router scalars: replicated
    return P(*([None] * ndim))


def _path_str(path) -> str:
    return "/".join(path)


def map_with_path(fn, tree, path=()):
    """`fn(path, leaf)` on every leaf, keeping the tree's structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], path + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(cfg: ArchConfig, params: Any, mesh) -> Any:
    """PartitionSpec tree matching `params` (`meta` tensors do)."""

    def spec_for(key_path, leaf) -> P:
        path = _path_str(key_path)
        base = _rule(path, leaf.ndim, cfg, mesh)
        if not cfg.tensor_parallel:
            # small-model policy: params replicated across "model" (the DP
            # axes still shard FSDP dims); kills every per-layer TP AR
            base = P(*(None if e == "model" else e for e in tuple(base)))
        return _fit(base, leaf.shape, mesh)

    return map_with_path(spec_for, params)


def state_specs(cfg: ArchConfig, state: Any, mesh) -> Any:
    """Specs for the full TrainState {"params","opt":{m,v,count},"step",...}."""
    out = {
        "params": param_specs(cfg, state["params"], mesh),
        "opt": {
            "m": param_specs(cfg, state["opt"]["m"], mesh),
            "v": param_specs(cfg, state["opt"]["v"], mesh),
            "count": P(),
        },
        "step": P(),
    }
    if "residuals" in state:
        out["residuals"] = param_specs(cfg, state["residuals"], mesh)
    return out


def cache_specs(cfg: ArchConfig, caches: Any, mesh) -> Any:
    """KV/state caches: batch -> dp axes; widest trailing dim -> "model".

    Cache layouts (batch is the first dim everywhere):
      dense KV   [B, S, Hkv, hd]   -> (dp, None, model-on-heads-or-hd)
      MLA latent [B, S, R]         -> (dp, None, "model")
      ring       [B, W, Hkv, hd]   -> like dense
      states     [B, ...]          -> (dp, None..., "model" on the last dim)
    """
    dp = _dp_axes(mesh)

    def spec_for(_key_path, leaf) -> P:
        nd = leaf.ndim
        entries: list = [dp] + [None] * (nd - 1)
        if nd >= 2:
            entries[-1] = "model"   # feature dim (hd / latent / state width)
        return _fit(P(*entries), leaf.shape, mesh)

    return map_with_path(spec_for, caches)


def batch_specs(cfg: ArchConfig, batch: Any, mesh) -> Any:
    dp = _dp_axes(mesh)

    def spec_for(_key_path, leaf) -> P:
        return _fit(P(*((dp,) + (None,) * (leaf.ndim - 1))), leaf.shape, mesh)

    return map_with_path(spec_for, batch)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def placements(mesh, spec: P) -> tuple:
    """The DTensor placements of `spec` on `mesh`: `Shard(i)` on every mesh
    dimension that spec entry i names, `Replicate()` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(a)] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's `jax.sharding.NamedSharding`)."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def to_named(mesh, spec_tree: Any) -> Any:
    return map_with_path(lambda _p, s: NamedSharding(mesh, s), spec_tree)


def distribute(tree: Any, shardings: Any) -> Any:
    """Place every tensor of `tree` with the matching `NamedSharding`: each
    rank keeps its own shard of the (identical on every rank) value, no
    communication."""
    from torch.distributed.tensor import distribute_tensor

    flat = {}

    def collect(path, s):
        flat[path] = s
    map_with_path(collect, shardings)
    return map_with_path(
        lambda path, t: distribute_tensor(
            t, flat[path].mesh, flat[path].placements, src_data_rank=None),
        tree)


# ---------------------------------------------------------------------------
# the dp axes at the sharded step's gather points
# ---------------------------------------------------------------------------

_MESH: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """The mesh in scope (the reference's `with mesh:`); `None` is none."""
    _MESH.append(mesh)
    try:
        yield mesh
    finally:
        _MESH.pop()


def current_mesh():
    return _MESH[-1] if _MESH else None


def dp_size(mesh) -> int:
    return _axes_size(mesh, _dp_axes(mesh))


def dp_index(mesh) -> int:
    """This rank's index among the dp shards (pod-major, as `Shard(0)` over
    ("pod", "data") splits)."""
    idx = 0
    for a in axis_names(mesh):
        if a in ("pod", "data"):
            idx = idx * mesh.size(axis_names(mesh).index(a)) \
                + mesh.get_local_rank(a)
    return idx


def batch_placements(mesh, model_dim: Optional[int] = None) -> tuple:
    """Batch (dim 0) on the dp axes; with `model_dim`, that dim on "model"
    too (the activation hint's batch x sequence layout)."""
    spec = [_dp_axes(mesh)]
    if model_dim is not None:
        spec += [None] * (model_dim - 1) + ["model"]
    return placements(mesh, P(*spec))


def _grad_placements(mesh) -> tuple:
    """A rank's gradient of a gathered value: a partial sum over the dp
    axes (each dp rank saw its own rows), equal over "model"."""
    from torch.distributed.tensor import Partial, Replicate

    return tuple(Partial() if a in ("pod", "data") else Replicate()
                 for a in axis_names(mesh))


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def gather_param(t, partial_model: bool = False):
    """The full local value of a parameter DTensor at its use (FSDP's
    all-gather); its gradient flows back as a reduce-scatter of the dp
    ranks' partial sums. With `partial_model`, each "model" rank's
    gradient is a share too (a rank uses only its block of the value, as
    a tensor-parallel region does), summed over "model" as well. A plain
    tensor passes through."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Partial, Replicate

    mesh = t.device_mesh
    full = t.redistribute(mesh, [Replicate()] * mesh.ndim)
    if not t.requires_grad:
        return full.to_local()
    grad = (tuple(Partial() for _ in range(mesh.ndim)) if partial_model
            else _grad_placements(mesh))
    return full.to_local(grad_placements=grad)


# ---------------------------------------------------------------------------
# tensor parallelism over "model" (Megatron's column/row-parallel pair)
# ---------------------------------------------------------------------------


def model_parallel(mesh, axis: str = "model") -> int:
    """The `axis` size of `mesh` (1 without that axis or without a
    mesh)."""
    if mesh is None or axis not in axis_names(mesh):
        return 1
    return mesh.size(axis_names(mesh).index(axis))


def tp_sharded(t, dim: int, axis: str = "model") -> bool:
    """Whether parameter `t` is a DTensor that `param_specs` placed with
    dim `dim` on mesh axis `axis` of more than one rank, and on no
    other."""
    if not is_dtensor(t) or model_parallel(t.device_mesh, axis) == 1:
        return False
    from torch.distributed.tensor import Shard

    names = axis_names(t.device_mesh)
    return all((p == Shard(dim)) == (a == axis)
               for a, p in zip(names, t.placements)
               if a == axis or isinstance(p, Shard))


def gather_param_tp(t, dim: int, axis: str = "model"):
    """This rank's `axis` block of a `tp_sharded(t, dim, axis)` parameter,
    gathered over the other axes (FSDP's all-gather); its gradient flows
    back as a reduce-scatter over those axes and stays sharded over
    `axis`."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = t.device_mesh
    keep = tuple(Shard(dim) if a == axis else Replicate()
                 for a in axis_names(mesh))
    block = t.redistribute(mesh, keep)
    if not t.requires_grad:
        return block.to_local()
    return block.to_local(grad_placements=tuple(
        Shard(dim) if a == axis else Partial()
        for a in axis_names(mesh)))


def model_rank(mesh) -> int:
    """This rank's coordinate on "model" (its block's index)."""
    return mesh.get_local_rank("model")


def model_block(mesh, n: int) -> slice:
    """This rank's block of a dim of `n` split evenly over "model"."""
    w = n // model_parallel(mesh)
    return slice(model_rank(mesh) * w, (model_rank(mesh) + 1) * w)


def _c10d(op: str, t: torch.Tensor, mesh, *args) -> torch.Tensor:
    """One functional collective over "model" (the ops the dry run
    counts), waited on."""
    name = mesh.get_group("model").group_name
    out = getattr(torch.ops._c10d_functional, op)(t.contiguous(), *args,
                                                  name)
    return torch.ops._c10d_functional.wait_tensor(out)


def model_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of `t` over the "model" ranks: one all-reduce (no
    gradient)."""
    return _c10d("all_reduce", t, mesh, "sum")


def model_max(t: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise max of `t` over the "model" ranks (no gradient)."""
    return _c10d("all_reduce", t, mesh, "max")


def _model_gather(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The "model" ranks' blocks of `t` concatenated along `dim` in rank
    order: one all-gather."""
    out = _c10d("all_gather_into_tensor", t.movedim(dim, 0), mesh,
                model_parallel(mesh))
    return out.movedim(0, dim)


def _model_scatter(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """This rank's block along `dim` of the sum of the "model" ranks' `t`:
    one reduce-scatter."""
    out = _c10d("reduce_scatter_tensor", t.movedim(dim, 0), mesh, "sum",
                model_parallel(mesh))
    return out.movedim(0, dim)


class _TPEnter(torch.autograd.Function):
    """Megatron's f: the identity forward; the backward sums the "model"
    ranks' gradients (each rank's block used the input for its share)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return model_sum(g, ctx.mesh), None


class _TPExit(torch.autograd.Function):
    """Megatron's g: the sum of the "model" ranks' partial outputs; the
    identity backward (every rank needs the whole output's gradient)."""

    @staticmethod
    def forward(ctx, y, mesh):
        return model_sum(y, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TPSum(torch.autograd.Function):
    """A sum of the "model" ranks' partials that every rank then uses for
    its own block (the partial attention scores, a split norm's sum of
    squares): all-reduced forward and backward (g then f)."""

    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh = mesh
        return model_sum(y, mesh)

    @staticmethod
    def backward(ctx, g):
        return model_sum(g, ctx.mesh), None


class _TPGather(torch.autograd.Function):
    """Each rank's block concatenated along `dim` into a value every rank
    holds whole; the backward keeps this rank's block of the (equal)
    gradient."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return _model_gather(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, model_rank(ctx.mesh) * ctx.n, ctx.n), \
            None, None


class _TPScatter(torch.autograd.Function):
    """This rank's block along `dim` of the sum of the ranks' partials
    (a reduce-scatter); the backward all-gathers the blocks' gradients."""

    @staticmethod
    def forward(ctx, y, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _model_scatter(y, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _model_gather(g, ctx.mesh, ctx.dim), None, None


# A value every "model" rank holds whole carries its whole gradient on
# every rank; a rank's block (of a column-parallel output, of a split
# feature dim) carries its own. `tp_enter` marks a whole value a rank uses
# for its block, `tp_exit` and `tp_sum` sum partials, `tp_gather` joins
# blocks, `tp_scatter` sums partials into blocks.


def tp_enter(x: torch.Tensor, mesh) -> torch.Tensor:
    """The input of a tensor-parallel region, equal on every "model"
    rank."""
    return _TPEnter.apply(x, mesh)


def tp_exit(y: torch.Tensor, mesh) -> torch.Tensor:
    """The output of a tensor-parallel region from each rank's partial."""
    return _TPExit.apply(y, mesh)


def tp_sum(y: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of the ranks' partials, used by each rank for its block."""
    return _TPSum.apply(y, mesh)


def tp_gather(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The ranks' blocks of `x` joined along `dim`."""
    return _TPGather.apply(x, mesh, dim % x.dim())


def tp_scatter(y: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """This rank's block along `dim` of the sum of the ranks' partials."""
    return _TPScatter.apply(y, mesh, dim % y.dim())


def gather_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every dp rank's rows of `x` stacked (all-gather over the dp axes),
    with a reduce-scatter of the partial gradients in the backward."""
    from torch.distributed.tensor import DTensor, Replicate

    d = DTensor.from_local(x, mesh, batch_placements(mesh), run_check=False)
    full = d.redistribute(mesh, [Replicate()] * mesh.ndim)
    return full.to_local(grad_placements=_grad_placements(mesh))


def local_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This dp rank's rows of a value every rank holds whole."""
    n = x.shape[0] // dp_size(mesh)
    return x.narrow(0, dp_index(mesh) * n, n)


def local_batch(t):
    """This rank's rows of a DTensor batch, activation or cache, whole in
    every other dim (the "model"-sharded features gathered); a plain tensor
    passes through."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    keep = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in t.placements]
    return t.redistribute(t.device_mesh, keep).to_local()


def from_local_batch(x: torch.Tensor, mesh):
    """A rank's rows as the batch-sharded DTensor they are part of."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x, mesh, batch_placements(mesh),
                              run_check=False)


def dp_mean(v: torch.Tensor, mesh) -> torch.Tensor:
    """The mean over the dp ranks of a per-rank value (one all-reduce)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    pl = [Partial() if a in ("pod", "data") else Replicate()
          for a in axis_names(mesh)]
    return DTensor.from_local(v, mesh, pl, run_check=False).full_tensor() \
        / dp_size(mesh)


def to_plain(t):
    """A replicated DTensor's value as a plain tensor."""
    return t.full_tensor() if is_dtensor(t) else t


def distribute_model(model, cfg: ArchConfig, mesh) -> Any:
    """Replace every parameter of `model` by a DTensor placed by
    `param_specs` on `mesh`, in place, and record the mesh on the model;
    returns the spec tree. Each rank keeps its shard of its own (equal,
    seeded) values."""
    from torch import nn
    from torch.distributed.tensor import distribute_tensor

    specs = param_specs(cfg, model.params(), mesh)
    flat = {}
    map_with_path(lambda path, s: flat.__setitem__(".".join(path), s),
                   specs)
    for name, p in list(model.named_parameters()):
        owner, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(owner)
        d = nn.Parameter(distribute_tensor(p.detach(), mesh,
                                           placements(mesh, flat[name]),
                                           src_data_rank=None),
                         requires_grad=p.requires_grad)
        if isinstance(mod, nn.ParameterDict):
            mod[leaf] = d
        else:
            setattr(mod, leaf, d)
    model.mesh = mesh
    return specs


def tree_local_batch(tree):
    """`local_batch` on every leaf of a cache tree (a layer's dict)."""
    return map_with_path(lambda _p, t: local_batch(t), tree) \
        if tree is not None else None


def tree_join_blocks(tree, mesh, split):
    """A layer's cache leaves whole: the "model" ranks' blocks of every
    leaf `split` names joined along the last dim (a layer that runs whole
    on a mesh; the caches stay split between steps)."""
    return {k: tp_gather(t, mesh, -1) if split[k] else t
            for k, t in tree.items()}


def tree_local_shard(tree):
    """This rank's block of every DTensor leaf of a cache tree, as
    `cache_specs` placed it (rows on the dp axes, the feature dim on
    "model"); plain leaves, already a rank's blocks, pass through."""
    return map_with_path(
        lambda _p, t: t.to_local() if is_dtensor(t) else t, tree) \
        if tree is not None else None
