"""aten graph -> CiM IR: the eligibility front end of the lowering compiler.

Port of `repro.cim.trace`. `trace(fn, *args)` captures a PyTorch function
with `torch.fx.experimental.proxy_tensor.make_fx(tracing_mode="fake")` (the
counterpart of `jax.make_jaxpr`: an aten graph whose nodes carry shape and
dtype in `meta["val"]`, computed on fake tensors, so a full-width capture
allocates nothing) and classifies every node into the ADRA cost model:

  single — elementwise integer ops one asymmetric dual-row access computes:
           add / sub (alpha 1) / compare (lt, le, gt, ge, eq, ne) / bitwise
           and-or-xor / minimum / maximum / neg / abs.
  multi  — ops the macro planner lowers to explicit access schedules: mul
           (shift-and-add), the integer contraction `int_contract` in the
           canonical [*B,M,K]x[*B,K,N] form (the reference's dot_general),
           a full sum (log-stride tree), `population_count` (plane tree).
  free   — zero-access peripheral wiring that keeps a fused region in the
           packed domain: int->int `_to_copy`, view / _unsafe_view /
           reshape (never permute), bitwise_not, `where.self` on a bool
           predicate (the reference's select_n) and expand of a scalar.
  host   — everything else (floats, gathers, 64-bit words, ...).

Nodes carry the reference's primitive names (`op.name`), so the cost model
and the executor read one vocabulary. Each eligible node carries its
planner `Schedule`, its access count and the operand word count one access
covers: the same numbers the executor (`repro_torch.cim.lower`) charges.

aten has no integer matmul with a widened result and no population count,
so both are registered here as custom ops (`repro_torch::int_contract`,
`repro_torch::population_count`) with fake implementations for the capture:
each captures as one node whose dtype is the signal. They are the plain
host computations (the JAX package computes them outside Pallas too), not
kernels.

Python scalars in a node's operands become `Literal`s (the reference's
weak-typed literals); tensors created inside the captured function become
graph constants, `ConstVal`s. Nested Python functions need no inlining:
the capture records aten ops only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.fx import Node
from torch.utils import _pytree as pytree

from . import planner

aten = torch.ops.aten

#: comparison op -> (engine predicate op, complement-at-periphery)
CMP_PRIMS: Dict[str, Tuple[str, bool]] = {
    "lt": ("lt", False), "gt": ("gt", False), "eq": ("eq", False),
    "ge": ("lt", True), "le": ("gt", True), "ne": ("eq", True),
}

#: elementwise single-access ops (besides the comparisons)
SINGLE_PRIMS = ("add", "sub", "and", "or", "xor", "min", "max", "neg", "abs")

#: multi-access ops lowered through the macro planner
MULTI_PRIMS = ("mul", "dot_general", "reduce_sum", "population_count")

#: zero-access peripheral ops (free inside a fused region)
FREE_PRIMS = ("convert_element_type", "reshape", "select_n", "not",
              "broadcast_in_dim")


# ---------------------------------------------------------------------------
# the two ops aten lacks
# ---------------------------------------------------------------------------


def _contract_shape(a: torch.Tensor, b: torch.Tensor) -> Tuple[int, ...]:
    if a.dim() < 2 or a.dim() != b.dim() or a.shape[:-2] != b.shape[:-2] \
            or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"int_contract needs [*B,M,K] x [*B,K,N], got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype.is_floating_point \
            or a.dtype.is_complex:
        raise ValueError(f"int_contract needs integer operands of one dtype, "
                         f"got {a.dtype} x {b.dtype}")
    return tuple(a.shape[:-1]) + (b.shape[-1],)


@torch.library.custom_op("repro_torch::int_contract", mutates_args=())
def int_contract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer (batched) matmul [*B,M,K] x [*B,K,N] -> int32, modulo
    2^32 (the reference's `preferred_element_type=int32` contraction).

    On the CPU in int32. CUDA has no integer matmul for these shapes, so
    there it runs in float64, exact for every partial sum below 2^53 (int8
    or int16 operands and any K below 2^22), then wraps to int32."""
    _contract_shape(a, b)
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    y = torch.matmul(a.double(), b.double())
    return (torch.remainder(y + 2.0 ** 31, 2.0 ** 32) - 2.0 ** 31) \
        .to(torch.int32)


@int_contract.register_fake
def _int_contract_fake(a, b):
    return a.new_empty(_contract_shape(a, b), dtype=torch.int32)


@torch.library.custom_op("repro_torch::population_count", mutates_args=())
def population_count(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each word's two's-complement pattern, in x's dtype
    (`lax.population_count`)."""
    v = x.to(torch.int64)
    count = torch.zeros_like(v)
    for i in range(dtype_bits(x.dtype)):
        count += (v >> i) & 1
    return count.to(x.dtype)


@population_count.register_fake
def _population_count_fake(x):
    return torch.empty_like(x)


# ---------------------------------------------------------------------------
# operands: avals, literals, constants
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Aval:
    """Shape and dtype of one operand (the counterpart of a jax aval)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True, eq=False)
class Literal:
    """A Python scalar operand of a node, typed as the op reads it."""

    val: Any
    aval: Aval


@dataclasses.dataclass(frozen=True, eq=False)
class ConstVal:
    """A tensor created inside the captured function (a graph constant):
    the lowering analogue of a jaxpr constvar binding."""

    val: torch.Tensor

    @property
    def aval(self) -> Aval:
        return Aval(tuple(int(d) for d in self.val.shape), self.val.dtype)


def aval_of(atom) -> Optional[Aval]:
    """Aval of a Node, Literal or ConstVal operand (None for a node whose
    value is not one tensor)."""
    if isinstance(atom, Node):
        val = atom.meta.get("val")
        if not isinstance(val, torch.Tensor):
            return None
        return Aval(tuple(int(d) for d in val.shape), val.dtype)
    return atom.aval


@dataclasses.dataclass
class TracedOp:
    """One node of the captured graph plus its ADRA classification."""

    node: Node                     # the fx node (host replay reads it)
    invars: Tuple[Any, ...]        # Node | Literal | ConstVal operands
    outvars: Tuple[Node, ...]
    name: str = ""                 # reference primitive name, else aten's
    kind: str = "host"             # single | multi | free | host
    n_bits: int = 0                # operand word width the access works at
    accesses: int = 0              # planned ADRA accesses (0 for free/host)
    words: int = 0                 # operand words one access covers
    schedule: Optional[planner.Schedule] = None
    why_host: str = ""             # ineligibility reason (diagnostics)
    axes: Optional[Tuple[int, ...]] = None   # reduce_sum: reduced dims

    @property
    def eligible(self) -> bool:
        return self.kind != "host"


@dataclasses.dataclass
class Trace:
    """The classified node list of one captured function."""

    gm: torch.fx.GraphModule
    ops: List[TracedOp]
    invars: Tuple[Node, ...]       # one placeholder per flat argument leaf
    outvars: Tuple[Any, ...]       # flat outputs: Node | ConstVal | scalar
    out_spec: Any                  # pytree spec of the output
    subst: Dict[Node, ConstVal]    # constant nodes -> their ConstVal

    @property
    def eligible_ops(self) -> int:
        return sum(1 for op in self.ops if op.eligible and op.accesses)

    @property
    def adra_accesses(self) -> int:
        """Total planned accesses: what a lowered execution's ledger shows
        (unbanked); banked placement multiplies per op by its tile count."""
        return sum(op.accesses for op in self.ops)


# ---------------------------------------------------------------------------
# dtype helpers
# ---------------------------------------------------------------------------


def dtype_bits(dtype) -> int:
    """Word width of an integer/bool dtype (bool -> 1)."""
    if dtype == torch.bool:
        return 1
    return torch.iinfo(dtype).bits


def dtype_signed(dtype) -> bool:
    return dtype != torch.bool and dtype.is_signed


def _intlike(aval: Aval) -> bool:
    return not aval.dtype.is_floating_point and not aval.dtype.is_complex


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def host_flops(op: TracedOp) -> int:
    """Scalar-op count a host execution of this op performs (the roofline
    numerator of the cost model): one per output element, and the standard
    2 * (out elements) * K for the contraction."""
    out = aval_of(op.outvars[0]) if op.outvars else None
    if out is None:
        return 0
    if op.name == "dot_general":
        k = int(aval_of(op.invars[0]).shape[-1])
        return 2 * _numel(out.shape) * k
    return _numel(out.shape)


def host_io_bits(op: TracedOp) -> int:
    """Bits moved through device memory if this op ran alone on the host:
    every operand read once plus every result written once, at true
    element widths."""
    bits = 0
    for v in tuple(op.invars) + tuple(op.outvars):
        aval = aval_of(v)
        if aval is None:
            continue
        try:
            b = dtype_bits(aval.dtype)
        except TypeError:
            b = aval.dtype.itemsize * 8
        bits += _numel(aval.shape) * b
    return bits


# ---------------------------------------------------------------------------
# aten -> reference vocabulary
# ---------------------------------------------------------------------------

#: elementwise ops whose operands are all positional arguments
_ELEMENTWISE = {
    aten.add.Tensor: "add", aten.add.Scalar: "add",
    aten.sub.Tensor: "sub", aten.sub.Scalar: "sub",
    aten.bitwise_and.Tensor: "and", aten.bitwise_and.Scalar: "and",
    aten.bitwise_or.Tensor: "or", aten.bitwise_or.Scalar: "or",
    aten.bitwise_xor.Tensor: "xor", aten.bitwise_xor.Scalar: "xor",
    aten.minimum.default: "min", aten.maximum.default: "max",
    aten.neg.default: "neg", aten.abs.default: "abs",
    aten.mul.Tensor: "mul", aten.mul.Scalar: "mul",
    aten.bitwise_not.default: "not", aten.where.self: "select_n",
    torch.ops.repro_torch.int_contract.default: "dot_general",
    torch.ops.repro_torch.population_count.default: "population_count",
}
for _cmp in CMP_PRIMS:
    _ELEMENTWISE[getattr(aten, _cmp).Tensor] = _cmp
    _ELEMENTWISE[getattr(aten, _cmp).Scalar] = _cmp

#: ops whose one tensor operand is the first argument (the rest are params)
_UNARY_PARAMS = {
    aten._to_copy.default: "convert_element_type",
    aten.view.default: "reshape", aten._unsafe_view.default: "reshape",
    aten.reshape.default: "reshape",
    aten.expand.default: "broadcast_in_dim",
    aten.sum.default: "reduce_sum", aten.sum.dim_IntList: "reduce_sum",
}

#: identity wrappers of a graph constant (`torch.tensor(...)` in the
#: captured function) that resolve to the constant itself
_CONST_WRAPPERS = (aten.lift_fresh_copy.default, aten.detach.default,
                   aten.detach_.default, aten.alias.default)


def _literal(val, dtype) -> Literal:
    if isinstance(val, bool):
        dt = torch.bool if dtype == torch.bool else dtype
    elif isinstance(val, int):
        dt = dtype
    else:
        dt = torch.get_default_dtype()
    return Literal(val=val, aval=Aval((), dt))


def _atoms(args, subst) -> Tuple[Any, ...]:
    """Every Node (substituted) in a nested argument structure."""
    out: List[Any] = []
    torch.fx.node.map_arg(args, lambda n: out.append(subst.get(n, n)))
    return tuple(out)


def _traced_op(node: Node, subst: Dict[Node, Any]) -> TracedOp:
    target = node.target
    if target in _ELEMENTWISE:
        name = _ELEMENTWISE[target]
        out = aval_of(node)
        tensors = [a for a in node.args if isinstance(a, Node)]
        ref = aval_of(tensors[0]) if tensors else None
        invars = []
        for a in node.args:
            if isinstance(a, Node):
                invars.append(subst.get(a, a))
            else:
                # a scalar takes the dtype the op computes in: the result's,
                # or the tensor operand's for a comparison
                dt = ref.dtype if (name in CMP_PRIMS and ref) else \
                    (out.dtype if out else torch.int32)
                invars.append(_literal(a, dt))
        op = TracedOp(node=node, invars=tuple(invars), outvars=(node,),
                      name=name)
        if node.kwargs.get("alpha", 1) != 1:
            op.why_host = "alpha != 1"
        return op
    if target in _UNARY_PARAMS:
        name = _UNARY_PARAMS[target]
        src = node.args[0]
        op = TracedOp(node=node, invars=(subst.get(src, src),),
                      outvars=(node,), name=name)
        if name == "convert_element_type" and \
                set(k for k, v in node.kwargs.items()
                    if v is not None) - {"dtype"}:
            op.why_host = "convert that changes layout or device"
        if name == "reduce_sum":
            ndim = len(aval_of(src).shape)
            dims = node.args[1] if len(node.args) > 1 else \
                node.kwargs.get("dim")
            if dims is None:
                op.axes = tuple(range(ndim))
            else:
                op.axes = tuple(sorted(int(d) % max(1, ndim) for d in dims))
        return op
    return TracedOp(node=node, invars=_atoms((node.args, node.kwargs), subst),
                    outvars=(node,), name=str(target))


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------


def _host(op: TracedOp, why: str) -> None:
    op.kind, op.why_host = "host", why


def _elementwise_shapes_ok(op: TracedOp) -> bool:
    """Operand shapes must equal the output shape or be scalar (the
    broadcast the executor replays at pack time)."""
    out = aval_of(op.outvars[0]).shape
    return all(aval_of(v).shape in (out, ()) for v in op.invars)


def _literal_fits(lit: Literal) -> bool:
    if isinstance(lit.val, bool) or lit.aval.dtype == torch.bool:
        return lit.val in (0, 1)
    info = torch.iinfo(lit.aval.dtype)
    return info.min <= lit.val <= info.max


def classify(op: TracedOp) -> None:
    """Fill in kind / n_bits / accesses / words / schedule for one op."""
    name = op.name
    if op.why_host:                                # set at capture
        _host(op, op.why_host)
        return
    if name not in SINGLE_PRIMS + MULTI_PRIMS + tuple(CMP_PRIMS) + FREE_PRIMS:
        _host(op, f"unsupported op {name!r}")
        return
    avals_in = [aval_of(v) for v in op.invars]
    out = aval_of(op.outvars[0])
    if out is None or any(a is None for a in avals_in):
        _host(op, "operand or result is not one tensor")
        return
    if not all(_intlike(a) for a in avals_in + [out]):
        _host(op, "non-integer operand or result")
        return
    if any(dtype_bits(a.dtype) > 32 for a in avals_in + [out]):
        _host(op, "64-bit words exceed the 32-bit plane codec")
        return
    if not all(_literal_fits(v) for v in op.invars
               if isinstance(v, Literal)):
        _host(op, "scalar outside its operand's range")
        return

    words = _numel(out.shape)

    # -- free peripheral ops ------------------------------------------------
    if name == "convert_element_type":
        src, dst = avals_in[0].dtype, out.dtype
        if dst == torch.bool and src != torch.bool:
            _host(op, "int->bool convert is a != 0 test, not a truncation")
            return
        op.kind, op.n_bits = "free", dtype_bits(dst)
        return
    if name == "reshape":
        op.kind = "free"
        return
    if name == "not":
        op.kind, op.n_bits = "free", dtype_bits(out.dtype)
        return
    if name == "select_n":
        if avals_in[0].dtype != torch.bool:
            _host(op, "where predicate is not boolean")
            return
        if not _elementwise_shapes_ok(op):
            _host(op, "where operand shapes differ from output")
            return
        op.kind = "free"
        return
    if name == "broadcast_in_dim":
        if avals_in[0].shape != ():
            _host(op, "only scalar broadcast is peripheral fanout")
            return
        op.kind = "free"
        return

    # -- single-access elementwise ops --------------------------------------
    if name in SINGLE_PRIMS or name in CMP_PRIMS:
        if not _elementwise_shapes_ok(op):
            _host(op, "operand shapes differ from output")
            return
        ref = next((a for a in avals_in if a.shape != ()), avals_in[0])
        n = dtype_bits(ref.dtype)
        op.kind, op.n_bits, op.words = "single", n, words
        if name in ("add", "sub"):
            op.schedule = planner.plan_elementwise((name,), n + 1, macro=name)
        elif name in ("and", "or", "xor"):
            op.schedule = planner.plan_elementwise((name,), n, macro=name)
        elif name in CMP_PRIMS:
            base, _ = CMP_PRIMS[name]
            op.schedule = planner.plan_elementwise((base,), 1, macro=name)
        elif name == "min":
            op.schedule = planner.plan_minimum(n)
        elif name == "max":
            op.schedule = planner.plan_maximum(n)
        elif name == "neg":
            op.schedule = planner.plan_neg(n)
        elif name == "abs":
            op.schedule = planner.plan_abs(n)
        op.accesses = op.schedule.accesses
        return

    # -- multi-access macro ops ---------------------------------------------
    if name == "mul":
        if not _elementwise_shapes_ok(op):
            _host(op, "operand shapes differ from output")
            return
        n = dtype_bits(out.dtype)
        op.schedule = planner.plan_multiply(
            n, n, signed_b=dtype_signed(out.dtype))
        op.kind, op.n_bits, op.words = "multi", n, words
        op.accesses = op.schedule.accesses
        return
    if name == "population_count":
        n = dtype_bits(out.dtype)
        if n < 2:
            _host(op, "popcount of a 1-bit word is the identity")
            return
        op.schedule = planner.plan_popcount(n)
        op.kind, op.n_bits, op.words = "multi", n, words
        op.accesses = op.schedule.accesses
        return
    if name == "reduce_sum":
        src = avals_in[0]
        if op.axes != tuple(range(len(src.shape))):
            _host(op, "partial reductions not lowered (full-tree only)")
            return
        n_elems = _numel(src.shape)
        if n_elems < 2:
            _host(op, "reduction over fewer than two elements")
            return
        n = dtype_bits(src.dtype)
        op.schedule = planner.plan_reduce_sum(n_elems, stride=1, n_bits=n)
        op.kind, op.n_bits, op.words = "multi", n, n_elems
        op.accesses = op.schedule.accesses
        return
    if name == "dot_general":
        # the canonical (possibly batched) form [*B, M, K] x [*B, K, N],
        # which `int_contract` accepts and nothing else: batch dims map
        # onto the word/tile axis of the broadcast layout, so the plan's
        # access count is independent of batch size per tile
        lhs, rhs = avals_in
        nb = len(lhs.shape) - 2
        batch = _numel(lhs.shape[:nb])
        m, k = int(lhs.shape[nb]), int(lhs.shape[nb + 1])
        n_cols = int(rhs.shape[nb + 1])
        n = dtype_bits(lhs.dtype)
        k_pad = 1 << planner._log2_ceil(k)
        if nb:
            op.schedule = planner.plan_batched_matmul(
                batch, k, n_cols, n_bits=n, signed=dtype_signed(lhs.dtype))
        else:
            op.schedule = planner.plan_matmul(
                k, n_cols, n_bits=n, signed=dtype_signed(lhs.dtype))
        op.kind, op.n_bits = "multi", n
        op.words = batch * m * k_pad * n_cols
        op.accesses = op.schedule.accesses
        return
    _host(op, f"unhandled op {name!r}")   # pragma: no cover


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------


def flatten_args(args) -> Tuple[List[torch.Tensor], Any]:
    """Flat tensor leaves of positional arguments (pytrees allowed) and
    their spec; every leaf must be a tensor."""
    leaves, spec = pytree.tree_flatten(args)
    for x in leaves:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"lowered functions take tensor leaves only, "
                            f"got {type(x).__name__}")
    return leaves, spec


def trace(fn, *args) -> Trace:
    """Capture `fn` on example `args` and classify every node (see module
    doc). Positional arguments only; pytrees are flattened the way
    `torch.utils._pytree` flattens them."""
    from torch.fx.experimental.proxy_tensor import make_fx

    leaves, in_spec = flatten_args(args)
    box: Dict[str, Any] = {}

    def flat_fn(*flat):
        out = fn(*pytree.tree_unflatten(list(flat), in_spec))
        out_leaves, box["spec"] = pytree.tree_flatten(out)
        return tuple(out_leaves)

    gm = make_fx(flat_fn, tracing_mode="fake")(*leaves)
    subst: Dict[Node, Any] = {}
    ops: List[TracedOp] = []
    invars: List[Node] = []
    outvars: Tuple[Any, ...] = ()
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            invars.append(node)
        elif node.op == "get_attr":
            subst[node] = ConstVal(getattr(gm, node.target))
        elif node.op == "call_function":
            src = node.args[0] if node.args else None
            if node.target in _CONST_WRAPPERS and \
                    isinstance(subst.get(src), ConstVal):
                subst[node] = subst[src]
                continue
            ops.append(_traced_op(node, subst))
        elif node.op == "output":
            outvars = tuple(subst.get(a, a) if isinstance(a, Node) else a
                            for a in node.args[0])
        else:                                    # pragma: no cover
            raise TypeError(f"unexpected graph node {node.op}")
    for op in ops:
        classify(op)
    return Trace(gm=gm, ops=ops, invars=tuple(invars), outvars=outvars,
                 out_spec=box["spec"], subst=subst)
