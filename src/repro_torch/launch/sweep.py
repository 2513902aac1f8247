"""Dry-run sweep: every (arch x shape x mesh) cell, one subprocess
per cell (isolation: a cell failure cannot poison the sweep; each process
holds its own fake process group of 256 or 512 ranks).

Port of `repro.launch.sweep`:

  PYTHONPATH=src python -m repro_torch.launch.sweep --out build/dryrun [--mesh single|multi|both]

Cells are ordered cheap->expensive (decode < prefill < train; small archs
first) and cached: reruns only execute missing/failed cells.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch import kernel_build

#: results go under the checkout's build/ (the dry run's default)
DEFAULT_OUT = str(kernel_build.BUILD_DIR.parent / "dryrun")

ARCH_COST = [  # rough size order for scheduling
    "xlstm-125m", "llama3.2-1b", "gemma-2b", "musicgen-large",
    "granite-3-8b", "recurrentgemma-9b", "qwen3-14b",
    "deepseek-v2-lite-16b", "internvl2-26b", "grok-1-314b",
]
SHAPE_COST = ["decode_32k", "long_500k", "prefill_32k", "train_4k"]


def cells(meshes):
    for shape in SHAPE_COST:
        for arch in ARCH_COST:
            for mesh in meshes:
                yield arch, shape, mesh


def run(out_dir: str, meshes, force: bool = False, timeout: int = 3000) -> int:
    os.makedirs(out_dir, exist_ok=True)
    failures = 0
    for arch, shape, mesh in cells(meshes):
        tag = f"{arch}__{shape}__{mesh}"
        path = os.path.join(out_dir, tag + ".json")
        if os.path.exists(path) and not force:
            with open(path) as f:
                prev = json.load(f)
            if prev.get("status") == "ok" or "skipped" in prev:
                print(f"[cached] {tag}: {prev.get('status', 'skipped')}", flush=True)
                continue
        t0 = time.monotonic()
        cmd = [sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--mesh", mesh,
               "--out", out_dir, "--force"]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
            ok = r.returncode == 0
        except subprocess.TimeoutExpired:
            ok = False
            with open(path, "w") as f:
                json.dump({"arch": arch, "shape": shape, "mesh": mesh,
                           "status": "error", "error": "compile timeout"}, f)
        dt = time.monotonic() - t0
        status = "ok" if ok else "FAIL"
        if not ok:
            failures += 1
        print(f"[{status}] {tag}  ({dt:.0f}s)", flush=True)
    return failures


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--mesh", default="both", choices=("single", "multi", "both"))
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    n = run(args.out, meshes, args.force)
    print(f"sweep complete; {n} failures")
    sys.exit(1 if n else 0)


if __name__ == "__main__":
    main()
