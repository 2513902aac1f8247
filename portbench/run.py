"""The benchmark of the PyTorch/CUDA port (`repro_torch`) on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout. `<cell>` is a `workloads` entry of
`BENCHMARK.json`; its configuration, traffic mix, own settings and limits,
and metrics are files found by name: `portbench/configs/<config>.json`,
`portbench/traffic/<traffic>.json`, `portbench/cells/<cell>.json` and
`portbench/metrics/<metric>.py`. With `--trace 0` the run reports the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics, the
profiled device time and a breakdown. Every run checks what the timed path
produced against a plain reference once the window has closed, and prints
each number compared beside its limit (the last lines of standard error,
and the result's last key). The last line of standard output is the result.

A run needs the card(s) its cell asks for and exits 2 without them. Kernel
builds go to `build/` inside the checkout. Nothing it loads may be JAX or
the JAX package `repro` (checked after the window, by top-level name).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench.harness import common  # noqa: E402

DRIVERS = {"serve": "portbench.harness.serve"}


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def evaluate(bench, workload: str, cfg_file, traffic, cell_file, seed: int,
             seconds: float, trace: bool, device: torch.device,
             t_start: float, calibrate=None):
    """One run of a cell from its files' contents: set-up, the window, the
    check, then the metrics. Returns (result, checks, record)."""
    import importlib

    driver = importlib.import_module(DRIVERS[traffic["kind"]])
    record = driver.run(cell_file, cfg_file, traffic, seed, seconds, trace,
                        device, t_start, calibrate=calibrate)
    record["peaks"] = common.peaks(record["device"]["kind"])
    checks = checks_of(record, cell_file.get("limits", {}))
    metrics = {}
    for m in common.cell_metrics(bench, workload, trace):
        reader = common.load_metric(m["name"])
        if reader.UNIT != m["unit"]:
            raise SystemExit(f"metric {m['name']}: unit {reader.UNIT!r} in "
                             f"its reader, {m['unit']!r} in BENCHMARK.json")
        value = reader.read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": all(c["ok"] for c in checks),
              "attempted": record["attempted"],
              "failed": record["attempted"] - record["completed"],
              "metrics": metrics, "device": record["device"]}
    if trace and record.get("trace"):
        tr = record["trace"]
        result["device"] = dict(result["device"], busy_s=tr["busy_s"],
                                window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    return result, checks, record


def checks_of(record, limits):
    """Every number compared, beside its limit (the cell file's)."""
    out = []

    def add(name, value, limit):
        ok = value is not None and value <= limit
        out.append({"name": name, "value": value, "limit": limit, "ok": ok})
    add("failed_requests", record["attempted"] - record["completed"], 0)
    add("window_compiles", int(record["compiled_in_window"]), 0)
    for name, limit in limits.items():
        add(name, record.get(name), limit)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = common.load_benchmark()
    cell = common.cell(bench, args.workload)
    common.require_cards(int(cell["chips"]))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(4)
    from repro_torch import kernel_build
    kernel_build.BUILD_DIR = ROOT / "build" / "repro_torch_kernels"

    result, checks, record = evaluate(
        bench, args.workload, common.load_json("configs", cell["config"]),
        common.load_json("traffic", cell["traffic"]),
        common.load_json("cells", args.workload), args.seed, args.seconds,
        bool(args.trace), device, T_START)
    result["card"] = power_limit()
    print("portbench: " + ", ".join(
        f"{k} {record.get(k)}" for k in (
            "rounds", "window_s", "setup_s", "reference_s", "check_tokens",
            "output_tokens", "median_gap")
        if k in record), file=sys.stderr)
    bad = common.forbidden_loaded()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}; no result",
              file=sys.stderr)
        return 3
    common.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
