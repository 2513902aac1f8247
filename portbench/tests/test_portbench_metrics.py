"""Each metric's arithmetic on a synthetic record and trace, the trace
reduction, and the check that a run loads no JAX module."""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench.harness import common, serve
from portbench.harness.trace import reduce_events

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class _Ev:
    """A raw profiler event as `kineto_results.events()` gives them."""

    def __init__(self, name, start, dur, cuda=True):
        self._n, self._s, self._d = name, start, dur
        self._dev = torch.autograd.DeviceType.CUDA if cuda else \
            torch.autograd.DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return False


def _trace():
    ev = [_Ev("fused_planes_kernel<4>", 0, 100), _Ev("aten_sum", 50, 100),
          _Ev("unrolled_elementwise_kernel<direct_copy_kernel_cuda>", 400,
              100),
          _Ev("elementwise_kernel<gpu_kernel_impl_nocast<direct_copy_kernel"
              "_cuda>>", 600, 30),
          _Ev("Memcpy DtoD (Device -> Device)", 630, 20),
          _Ev("bench.decode", 0, 900),
          _Ev("bench.decode", 0, 1000, cuda=False),
          _Ev("bench.sample", 520, 300, cuda=False)]
    return reduce_events(ev, 1e-6, {"fused_bytes": 335})


def test_trace_reduction():
    tr = _trace()
    # busy: [0, 150), [400, 500) and [600, 650): the annotation's device
    # copy is not work
    assert tr["busy_s"] == pytest.approx(300e-9)
    assert tr["kernels"]["aten_sum"] == pytest.approx(100e-9)
    # the gap [150, 400) lies in bench.decode alone, [500, 600) in
    # bench.sample inside it: the innermost span names a gap
    assert tr["idle_gaps"] == [["decode", pytest.approx(250e-9)],
                               ["sample", pytest.approx(100e-9)]]
    assert tr["device_ops"][0][1] == pytest.approx(100e-9)


def _record(**kw):
    rec = {"window_s": 2.0, "setup_s": 3.0, "output_tokens": 10,
           "gaps_ms": [float(i) for i in range(1, 101)],
           "decode_step_ms": [5.0, 7.0, 6.0], "prefill_ms": [10.0, 20.0],
           "ledger_accesses": 500, "dispatches": 40, "cim": True,
           "trace": _trace(), "peaks": common.peaks("NVIDIA H100 80GB HBM3"),
           "flop_tokens": [1, 2, 3], "n_active": 1e9, "step_s": 0.5,
           "arch": type("A", (), {"mla": None, "head_dim": 4, "n_heads": 2,
                                  "n_layers": 3})()}
    rec.update(kw)
    return rec


@pytest.mark.parametrize("name,value", [
    ("output_tok_s", 5.0), ("setup_s", 3.0),
    ("tpot_p95_ms", 95.0),            # sorted[round(0.95 * 99)] = 95
    ("decode_step_ms_p50", 6.0), ("prefill_ms_mean", 15.0),
    ("cim_accesses_per_token", 50.0), ("cim_dispatches_per_token", 4.0),
    ("outside_fused_share", 100.0 * 250e-9 / 300e-9),
    ("fused_planes_roofline", 100.0 * (335 / 3.35e12) / 100e-9),
    ("cast_share", 100.0 * 100e-9 / 300e-9),
    ("copy_share", 100.0 * 50e-9 / 300e-9),
    ("device_idle_share.decode", 100.0 * (1 - 300e-9 / 1e-6)),
    # 2 x 1e9 x 3 tokens + 2 x 2 heads x (4 + 4) x 3 layers x (1 + 2 + 3)
    ("decode_mfu", 100.0 * (6e9 + 96 * 6) / (0.5 * 989e12)),
])
def test_metric_arithmetic(name, value):
    assert common.load_metric(name).read(_record()) == pytest.approx(value)


def test_readers_find_nothing_to_read():
    bare = {"window_s": 1.0, "setup_s": 1.0, "cim": False, "trace": None,
            "peaks": None}
    for name in ("tpot_p95_ms", "cim_accesses_per_token", "outside_fused_share",
                 "fused_planes_roofline", "cast_share", "copy_share",
                 "decode_mfu",
                 "device_idle_share.decode", "output_tok_s"):
        assert common.load_metric(name).read(bare) is None, name


def test_plan_of_the_cim_cell():
    cfg = common.load_json("configs", "granite-3-8b-stage")
    plan = serve.plan_accesses(cfg, common.load_json("traffic", "cim-decode"))
    # per layer (15 + 12) + (15 + 12) + (15 + 14) + (15 + 7) + (15 + 6)
    assert plan == {"accesses": 1260, "dispatches": 50}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    assert "repro" not in common.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    assert common.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro.cim", sys)
    assert common.forbidden_loaded() == ["repro"]


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = ['portbench', '.', 'src']; "
            "import run; from portbench.harness import common, serve, "
            "check, trace; import portbench.reference.decoder; "
            "import repro_torch.launch.serve, repro_torch.cim.lower; "
            "print(common.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_benchmark_file_keeps_the_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = set()
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
        f = json.loads((ROOT / c["file"]).read_text())
        assert sorted(f["reduced"]) == sorted(c["reduced"])
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert (ROOT / "portbench/traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "portbench/cells" / f"{w['name']}.json").is_file()
        assert w["chips"] == 1
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        reader = common.load_metric(m["name"])
        assert reader.UNIT == m["unit"]
        if "layer" in m:
            assert reader.LAYER == m["layer"] and reader.MOVES == m["moves"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and all(m["bound"] <= 0.25 for m in e2e.values())
    for w in bench["workloads"]:
        got = common.cell_metrics(bench, w["name"], False)
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2
        moved = {m["name"] for m in got}
        per = common.cell_metrics(bench, w["name"], True)
        assert per and all(m["moves"] in moved for m in per)
