"""Readings that the limits of a serve cell are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--control fp8|cim4]

For each seed, in one process: the cell's set-up and one round of its
traffic (a window of 0 seconds holds one round), then the reference's
replay of the run. A seed in `--control-seeds` also replays the
control, the reference in the lower precision, beside it. One JSON line a
seed (the program's widest and mean gap, the control's), then a summary:
the lower readings (the program's largest) and the upper (the control's
smallest).
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run  # noqa: E402  (sets the environment and the paths)

import torch  # noqa: E402

from portbench.harness import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control", default="")
    args = ap.parse_args(argv)
    bench = common.load_benchmark()
    cell = common.cell(bench, args.workload)
    common.require_cards(int(cell["chips"]))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(4)
    cfg_file = common.load_json("configs", cell["config"])
    traffic = common.load_json("traffic", cell["traffic"])
    cell_file = dict(common.load_json("cells", args.workload), limits={})
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    prog, ctl, prog_mean, ctl_mean = [], [], [], []
    for seed in sorted(set(seeds) | ctl_seeds):
        torch.cuda.reset_peak_memory_stats(device)
        t = time.perf_counter()
        calib = {"control": args.control} if seed in ctl_seeds else None
        result, checks, rec = run.evaluate(
            bench, args.workload, cfg_file, traffic, cell_file, seed, 0.0,
            False, device, t, calibrate=calib)
        line = {"seed": seed, "widest_gap": rec["widest_gap"],
                "mean_gap": rec["mean_gap"], "median_gap": rec["median_gap"],
                "control_widest_gap": rec["control_widest_gap"],
                "control_mean_gap": rec.get("control_mean_gap"),
                "check_tokens": rec["check_tokens"],
                "setup_s": rec["setup_s"], "window_s": rec["window_s"],
                "reference_s": rec["reference_s"],
                "peak_bytes": rec["device"]["memory_peak_bytes"],
                "step_access_gap": rec.get("step_access_gap"),
                "step_dispatch_gap": rec.get("step_dispatch_gap"),
                "checks": {c["name"]: c["value"] for c in checks}}
        print(json.dumps(line), flush=True)
        if seed in seeds:
            prog.append(rec["widest_gap"])
            prog_mean.append(rec["mean_gap"])
        if rec["control_widest_gap"] is not None:
            ctl.append(rec["control_widest_gap"])
            ctl_mean.append(rec["control_mean_gap"])
        del rec, result
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "card": run.power_limit(),
                      "lower": max(prog) if prog else None,
                      "upper": min(ctl) if ctl else None,
                      "program": prog, "control": ctl,
                      "lower_mean": max(prog_mean) if prog_mean else None,
                      "upper_mean": min(ctl_mean) if ctl_mean else None,
                      "program_mean": prog_mean, "control_mean": ctl_mean}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
