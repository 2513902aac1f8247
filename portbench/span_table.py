"""One run of a cell, as `run.py` makes it, with the program's spans read
from its trace: device time by span path, the shares of the decode step's
parts, and the idle gaps named by the span the host was in.

    python3 portbench/span_table.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> [--out <file.jsonl>]

`main` extends `trace.Tracer.summary` in its process by
`harness/spans.reduce_spans` (the benchmark's own reduction is left as it
is). Prints one JSON line (appended to `--out` too): every metric of the
cell read from the run's record, both trace modes' alike; the span shares
(`harness/spans.SHARES`); the device seconds of the traced window split
into the fused kernel, the packed glue, the graphs' copies, the decode's
float ops, the prefill's, the insert's, the sampling's and the rest; the
span table, largest device time first; the idle gaps as the benchmark
names them and with their program span; how device operations linked to
their launches; and each traced decode step's host milliseconds (the
`bench.decode` spans, present with or without the program's spans). Run
it on a program without spans and the span keys come out empty.
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

from portbench.harness import common, spans, trace  # noqa: E402

#: device-time parts of a traced CiM decode window, by span path
PARTS = (
    ("fused", lambda p, n: p[-1] == "graph.replay" and "fused_planes" in n),
    ("packed_glue", lambda p, n: p[-1] == "graph.replay"),
    ("graph_copies", lambda p, n: p[-1] in ("graph.copy_in",
                                            "graph.copy_out")),
    ("decode_float", lambda p, n: p[0] == "serve.decode"
     and "cim.program" not in p),
    ("prefill_float", lambda p, n: p[0] == "serve.prefill"
     and "cim.program" not in p),
    ("insert", lambda p, n: p[0] == "serve.insert"),
    ("sample", lambda p, n: p[0] == "serve.sample"),
    ("other", lambda p, n: True),
)


def _summary(tracer, plain=trace.Tracer.summary):
    out = plain(tracer)
    if out is not None:
        events = list(tracer.prof.profiler.kineto_results.events())
        out["benchmark_idle_gaps"] = out["idle_gaps"]
        out.update(spans.reduce_spans(events))
        out["bench_decode_ms"] = [
            e.duration_ns() * 1e-6 for e in events
            if e.name() == "bench.decode"
            and e.device_type() == torch.autograd.DeviceType.CPU]
    return out


def parts(tr):
    """Busy seconds' shares (%) by part, each operation in its first."""
    out = {name: 0.0 for name, _ in PARTS}
    for path, row in tr["spans"].items():
        p = path.split("/")
        for n, v in row["kernels"].items():
            out[next(name for name, keep in PARTS if keep(p, n))] += v
    out["unattributed"] = sum(tr["kernels"].values()) - tr["attributed_s"]
    return {k: 100.0 * v / tr["busy_s"] for k, v in out.items()}


def replays_per_decode(tr):
    """Graph replays a traced decode step makes."""
    decode = tr["spans"].get("serve.decode")
    if not decode:
        return None
    return sum(row["calls"] for path, row in tr["spans"].items()
               if path.startswith("serve.decode/")
               and path.endswith("/graph.replay")) / decode["calls"]


def table(tr, rows=40, kernels=3):
    return [[path, row["calls"], row["host_s"], row["host_self_s"],
             row["device_s"],
             [[n[:60], v] for n, v in list(row["kernels"].items())[:kernels]]]
            for path, row in sorted(tr["spans"].items(),
                                    key=lambda kv: -kv[1]["device_s"])[:rows]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    bench = common.load_benchmark()
    cell = common.cell(bench, args.workload)
    common.require_cards(int(cell["chips"]))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(4)
    from repro_torch import kernel_build
    kernel_build.BUILD_DIR = run.ROOT / "build" / "repro_torch_kernels"
    trace.Tracer.summary = _summary

    result, checks, rec = run.evaluate(
        bench, args.workload, common.load_json("configs", cell["config"]),
        common.load_json("traffic", cell["traffic"]),
        common.load_json("cells", args.workload), args.seed, args.seconds,
        bool(args.trace), device, T0)
    metrics = {}
    for m in bench["end_to_end"] + bench["per_layer"]:
        value = common.load_metric(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = value
    line = {"workload": args.workload, "seed": args.seed,
            "trace": args.trace, "card": run.power_limit(),
            "correct": result["correct"],
            "checks": {c["name"]: c["value"] for c in checks},
            "metrics": metrics,
            "decode_step_ms_p50": common.median(rec["decode_step_ms"]),
            "decode_steps": len(rec["decode_step_ms"])}
    tr = rec.get("trace")
    if tr:
        line.update(
            shares={k: f(tr) for k, f in spans.SHARES.items()},
            busy_s=tr["busy_s"], window_s=tr["window_s"],
            kernel_s=sum(tr["kernels"].values()),
            attributed_s=tr["attributed_s"], links=tr["links"],
            parts=parts(tr) if tr["spans"] else None,
            traced_decode_ms_p50=common.median(tr["bench_decode_ms"]),
            traced_decode_steps=len(tr["bench_decode_ms"]),
            replays_per_decode=replays_per_decode(tr),
            decode_enqueue_ms=tr["decode_enqueue_ms"],
            idle_gaps=tr["idle_gaps"],
            benchmark_idle_gaps=tr["benchmark_idle_gaps"],
            spans=table(tr))
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
