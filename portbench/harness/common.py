"""What every cell of the benchmark shares: finding a cell's files by name,
seeds, the port's configuration built from a configuration file, weights
made on the device from the seed, the device's description, the check that
no JAX module was loaded, and the result line.

The port (`repro_torch`) is imported only inside functions, so that the
CPU tests of this folder and its plain references import without it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import statistics
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

#: top-level module names that may not be loaded in a run: JAX, and the
#: JAX package the port was written from (compared whole: the port's own
#: name, `repro_torch`, begins with it)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


# ---------------------------------------------------------------------------
# files by name
# ---------------------------------------------------------------------------


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str) -> Dict[str, Any]:
    """`portbench/<kind>/<name>.json`: a configuration or a traffic mix."""
    with open(BENCH_DIR / kind / f"{name}.json") as f:
        return json.load(f)


def load_metric(name: str):
    """`portbench/metrics/<name>.py`: a per-layer metric's reader module
    (`UNIT`, `LAYER`, `MOVES`, `read(ctx)`)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: Dict[str, Any], workload: str, trace: bool
                 ) -> List[Dict[str, Any]]:
    """The metrics a run of `workload` reports: its end-to-end metrics
    (trace 0) or its per-layer metrics (trace 1), each by its `workloads`
    key, a per-layer metric without one wherever its `moves` is reported."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in moved
                                 else [])]


# ---------------------------------------------------------------------------
# seeds
# ---------------------------------------------------------------------------


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed for one stream of a run (`keys` name it), drawn from
    the run's seed: the same seed and keys give the same stream."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    for k in keys:
        words.append(k if isinstance(k, int) else
                     int.from_bytes(str(k).encode()[:4].ljust(4, b"\0"),
                                    "little"))
    a, b = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


# ---------------------------------------------------------------------------
# the port's configuration
# ---------------------------------------------------------------------------


def _get(d: Dict[str, Any], dotted: str):
    for part in dotted.split("."):
        d = d[part]
    return d


def port_arch(cfg_file: Dict[str, Any]):
    """The port's `ArchConfig` for a configuration file: its `port` fields,
    each one that `port_keys` pairs with a key of the file held equal to
    it (so the program runs the sizes the file states)."""
    from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

    fields = dict(cfg_file["port"])
    for port_key, file_key in cfg_file.get("port_keys", {}).items():
        have, want = _get(fields, port_key), cfg_file[file_key]
        if have != want:
            raise ValueError(f"{cfg_file['name']}: port {port_key} = {have!r} "
                             f"but {file_key} = {want!r}")
    if fields.get("moe"):
        fields["moe"] = MoEConfig(**fields["moe"])
    if fields.get("mla"):
        fields["mla"] = MLAConfig(**fields["mla"])
    return ArchConfig(**fields)


def with_serve_mode(arch, traffic: Dict[str, Any]):
    """The configuration a serve cell runs: on the CiM path the port's
    `with_cim` at the traffic's bits, weights pinned resident."""
    if traffic["path"] != "cim":
        return arch
    from repro_torch.models.model import with_cim

    return dataclasses.replace(with_cim(arch, int(traffic.get("cim_bits", 8))),
                               cim_resident=True)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def _fan_in(path: str, shape) -> int:
    """The contraction width a weight's draw is scaled by (normal with
    variance 1/fan_in)."""
    name = path.split("/")[-1]
    if name == "table":
        return shape[1]
    if name == "wo":
        return math.prod(shape[:-1])
    if len(shape) == 3 and name in ("w_in", "w_gate", "w_out") \
            and "/mlp/" in path:
        return shape[1]                     # [experts, in, out]
    return shape[0]


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _set(tree, path: str, value) -> None:
    parts = path.split("/")
    for p in parts[:-1]:
        tree = tree[int(p)] if isinstance(tree, list) else tree[p]
    tree[parts[-1]] = value


def make_weights(arch, seed: int, device, serving: bool):
    """The parameter tree the port's `Model(params=)` takes, drawn here on
    `device` from the seed: each leaf of the port's layout (read from its
    `meta` initialisation: shapes and dtypes only) in the dtype it is served
    (`serving`) or trained in, layers of one structure drawn together in one
    call per leaf. Norm scales are 1 + 0.1 N(0, 1), everything else normal
    with variance 1/fan_in."""
    from repro_torch.models.model import init_params

    layout = init_params(arch, None, torch.device("meta"),
                         for_serving=serving)
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, "weights"))
    tree = _skeleton(layout)
    # layers that share a structure are drawn together
    groups: Dict[tuple, List[int]] = {}
    for i, layer in enumerate(layout["layers"]):
        sig = tuple((p, tuple(t.shape), t.dtype) for p, t in _walk(layer))
        groups.setdefault(sig, []).append(i)
    for sig, idx in groups.items():
        for path, shape, dtype in sig:
            stack = _draw(gen, (len(idx),) + shape, dtype, device,
                          f"layers/0/{path}")
            for j, i in enumerate(idx):
                _set(tree["layers"][i], path, stack[j])
    for key in layout:
        if key == "layers":
            continue
        for path, t in _walk(layout[key]):
            _set(tree[key], path, _draw(gen, tuple(t.shape), t.dtype, device,
                                        f"{key}/{path}"))
    return tree


def _draw(gen, shape, dtype, device, path) -> torch.Tensor:
    name = path.split("/")[-1]
    if name == "scale":
        t = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32).mul_(0.1).add_(1.0)
        return t.to(dtype)
    t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    body = shape[1:] if path.startswith("layers/") else shape
    return t.mul_(1.0 / math.sqrt(_fan_in(path, body)))


def _skeleton(tree):
    """`tree`'s dicts and lists with every leaf None."""
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return None


def active_params(arch, tree) -> float:
    """Parameters one token reads in a forward pass: every leaf but the
    embedding table, the routed experts' leaves scaled by top_k / experts
    (the benchmark's copy of `launch/roofline.py::active_param_count`)."""
    total = 0.0
    for path, t in _walk(tree):
        if path.endswith("embed/table"):
            continue
        n = float(t.numel())
        if arch.moe is not None and t.dim() == 3 and "/mlp/" in path \
                and path.split("/")[-1] in ("w_in", "w_gate", "w_out"):
            n *= arch.moe.top_k / arch.moe.n_experts
        total += n
    return total


# ---------------------------------------------------------------------------
# the run's surroundings
# ---------------------------------------------------------------------------


def require_cards(n: int) -> None:
    """Exit without a result unless `n` CUDA cards are there."""
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False; no result",
              file=sys.stderr)
        raise SystemExit(2)
    if torch.cuda.device_count() < n:
        print(f"portbench: the cell needs {n} cards, "
              f"{torch.cuda.device_count()} found; no result", file=sys.stderr)
        raise SystemExit(2)


def forbidden_loaded() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's (whole names: `repro_torch` is not `repro`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def device_record(device: torch.device) -> Dict[str, Any]:
    """The result's `device`: the one card a cell runs on, its peak."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def peaks(kind: str) -> Optional[Dict[str, float]]:
    """The published peaks of the card named `kind` (`peaks.json`), or
    None for a card the table does not hold."""
    with open(BENCH_DIR / "peaks.json") as f:
        table = json.load(f)
    for name, row in table["cards"].items():
        if name in kind:
            return row
    return None


def percentile(xs: List[float], q: float) -> Optional[float]:
    """The engine's percentile (`launch/serve.py::_percentile`, copied):
    the sorted sample's element at round(q/100 * (n-1))."""
    if not xs:
        return None
    ys = sorted(xs)
    i = min(len(ys) - 1, max(0, int(round(q / 100.0 * (len(ys) - 1)))))
    return ys[i]


def median(xs: List[float]) -> Optional[float]:
    return statistics.median(xs) if xs else None


def emit(result: Dict[str, Any], checks: List[Dict[str, Any]]) -> None:
    """The checks' last lines on standard error, then the result line (its
    `checks` key last) as the last line of standard output."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"({'ok' if c['ok'] else 'FAILED'})", file=sys.stderr)
    out = dict(result)
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
