#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py            # from the repository root, one H100

Phases, each fatal on failure:
  1. build   — compile the fused bit-plane kernel from
               src/repro_torch/cim/csrc/fused_planes.cu (nvcc, sm_90a) and
               print the card's name and power limit;
  2. kernel  — hold the kernel bit for bit against its plain PyTorch version
               over the op surface (every single op, the full op set and
               random subsets, n_bits 2-33, ragged widths, a tiled stack),
               then time both at the main path's largest access;
  3. serve   — gemma-2b at full width through the port's serve entry point
               (int8 CiM decode, streamed repack phase, resident phase, warm
               replay), asserting 2214 accesses and 90 dispatches per decode
               step and that the kernel's launch count covers every access;
  4. tokens  — the same request schedule through the quantized host twins
               must give identical greedy tokens.
Earlier lines carry the metrics and one JSON `kernels` line; the last line
is {"ok": true, "device": {...}}. Without CUDA it exits non-zero and prints
no result. `--profile` adds a torch.profiler breakdown of one warm
resident decode step.
"""
import dataclasses
import json
import os
import random
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SERVE_ARGS = ["--arch", "gemma-2b", "--preset", "full", "--device", "cuda",
              "--slots", "2", "--requests", "4", "--prompt-len", "8",
              "--gen", "8", "--cim-lower", "--cim-resident", "--assert-warm"]
#: per decode step at gemma-2b full width, prompt 8 + gen 8 (Tmax 16):
#: 18 layers x [(2*8-1) + ceil(log2 K)] over K = 2048, 2048, 16384 (MLP),
#: 256 (QK^T), 16 (AV)
STEP_ACCESSES = 18 * (26 + 26 + 29 + 23 + 19)
STEP_DISPATCHES = 18 * 5
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
INT_OPS_PER_S = 67e12            # H100 SXM non-tensor 32-bit rate


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_bounds(n_bits: int, w: int, ops) -> dict:
    from repro_torch.cim import opset
    rows = sum(opset.out_rows(op, n_bits) for op in ops)
    moved = (2 * n_bits + rows) * w * 4
    n_bool = sum(op in opset.BOOLEAN_OPS for op in ops)
    int_ops = w * n_bits * (2 + 4 * opset.needs_add_chain(ops)
                            + 6 * opset.needs_sub_chain(ops) + 3 * n_bool)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": moved}


def phase_kernel(dev) -> dict:
    """Kernel against the plain version, bit for bit (int32 views are the
    uint32 patterns), then timed at the main path's largest access."""
    import torch
    from repro_torch.cim import opset
    from repro_torch.cim.fused_kernel import fused_planes_op, fused_planes_op_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    rng = random.Random(0)

    def planes(shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    max_err = 0
    cases = 0

    def check(a, b, ops):
        nonlocal max_err, cases
        got = fused_planes_op(a, b, ops)
        want = fused_planes_op_ref(a, b, ops)
        for op, g, r in zip(ops, got, want):
            assert g.shape == r.shape, (op, g.shape, r.shape)
            # difference of the uint32 patterns (int32 views), exact in int64
            err = int((g.to(torch.int64) - r.to(torch.int64)).abs().max())
            max_err = max(max_err, err)
            if err:
                raise AssertionError(f"kernel != plain for {op} at "
                                     f"{tuple(a.shape)}: max diff {err}")
        cases += 1

    widths = (1, 31, 255, 257, 1000, 4099)
    for n_bits in range(2, 34):
        w = widths[n_bits % len(widths)]
        a, b = planes((n_bits, w)), planes((n_bits, w))
        check(a, b, opset.ALL_OPS)
        for _ in range(3):
            k = rng.randint(1, len(opset.ALL_OPS))
            check(a, b, tuple(rng.sample(opset.ALL_OPS, k)))
    for op in opset.ALL_OPS:
        for n_bits, w in ((2, 257), (17, 256), (33, 1028)):
            a, b = planes((n_bits, w)), planes((n_bits, w))
            check(a, b, (op,))
    for w in (513, 512):                                   # leading tile axis
        a, b = planes((3, 9, w)), planes((3, 9, w))
        check(a, b, opset.ALL_OPS)
    # contiguous views starting 4 bytes into their storage
    a, b = planes((7 * 1000 + 1,)), planes((7 * 1000 + 1,))
    check(a[1:].view(7, 1000), b[1:].view(7, 1000), opset.ALL_OPS)

    # the main path's largest access: the last tree-reduction add of the
    # down projection at 2 slots — [2, 16384, 2048] words, 29 planes in.
    # Single timings of one access vary by 2x from call to call, so each
    # shape reports its median over 5 rounds of 10 launches.
    n_bits, w, ops = 29, (2 * 16384 * 2048) // 32, ("add",)
    a, b = planes((n_bits, w)), planes((n_bits, w))
    check(a, b, ops)
    launches0 = fused_planes_op.launches
    rounds = sorted(cuda_ms(lambda: fused_planes_op(a, b, ops), reps=10)
                    for _ in range(5))
    assert fused_planes_op.launches > launches0
    ms = rounds[2]
    plain_ms = cuda_ms(lambda: fused_planes_op_ref(a, b, ops), reps=5)
    bounds = kernel_bounds(n_bits, w, ops)
    print(f"kernel: {cases} cases bit-exact (max diff {max_err}); n_bits "
          f"{n_bits} W {w} {ops}: median {ms:.4f} ms (rounds "
          f"{rounds[0]:.4f}-{rounds[-1]:.4f}), plain {plain_ms:.4f} ms, "
          f"bound {bounds['bound_ms']:.4f} ms ({bounds['bound_by']}, "
          f"{bounds['bytes']} B)")
    # a second main-path shape: the multiply's AND partial product
    n2, ops2 = 16, ("and",)
    a2, b2 = planes((n2, w)), planes((n2, w))
    check(a2, b2, ops2)
    rounds2 = sorted(cuda_ms(lambda: fused_planes_op(a2, b2, ops2), reps=10)
                     for _ in range(5))
    print(f"kernel: n_bits {n2} W {w} {ops2}: median {rounds2[2]:.4f} ms "
          f"(rounds {rounds2[0]:.4f}-{rounds2[-1]:.4f}), bound "
          f"{kernel_bounds(n2, w, ops2)['bound_ms']:.4f} ms")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bounds["bound_ms"], "bound_by": bounds["bound_by"],
            "shape": [n_bits, w, list(ops)], "cases": cases}


def phase_profile(model, dev) -> None:
    """One warm resident decode step under torch.profiler: device time by
    kernel, the fused kernel's share, and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve

    m = model.derive(dataclasses.replace(model.cfg, cim_resident=True),
                     resident_spec=serve.resident_array_spec(model.cfg, 2))
    serve.fresh_cim_state()
    caches = m.init_caches(2, 16)
    step = {"tokens": torch.tensor([[1], [2]], device=dev),
            "positions": torch.tensor([8, 8], dtype=torch.int32, device=dev)}
    m.decode_step(caches, step)                   # pins the weights
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        m.decode_step(caches, step)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    fused_ms = sum(r[2] for r in rows if "fused_planes_kernel" in r[0])
    print(f"profile: decode step wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f}), "
          f"fused kernel {fused_ms:.1f} ms "
          f"({fused_ms / max(busy_ms, 1e-9):.3f} of busy)")
    for name, count, ms in rows[:12]:
        print(f"profile:   {ms:9.2f} ms  x{count:<6d} {name[:90]}")
    serve.fresh_cim_state()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from repro_torch.cim import fused_kernel

    profile = "--profile" in sys.argv[1:]
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases = {}

    t = time.perf_counter()
    lib = fused_kernel.build()
    phases["build_s"] = time.perf_counter() - t
    for line in fused_kernel.BUILD_LOG.get("nvcc", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"nvcc: {line.strip()}")
    print(f"build: {lib.name} in {phases['build_s']:.2f} s")
    smi = smi_line()
    print(f"gpu: {smi}")

    t = time.perf_counter()
    kern = phase_kernel(dev)
    phases["kernel_s"] = time.perf_counter() - t

    from repro_torch.configs import preset_config
    from repro_torch.launch import serve
    from repro_torch.models.model import build, with_cim

    t = time.perf_counter()
    model = build(with_cim(preset_config("gemma-2b", "full"), 8),
                  device=dev, seed=0)
    torch.cuda.synchronize()
    phases["init_s"] = time.perf_counter() - t

    t = time.perf_counter()
    fused_kernel.fused_planes_op.launches = 0
    out = serve.main(SERVE_ARGS, model=model)
    launches = fused_kernel.fused_planes_op.launches
    phases["serve_s"] = time.perf_counter() - t
    reps = out["phases"]
    for name, rep in reps.items():
        assert set(rep["step_accesses"]) == {STEP_ACCESSES}, \
            (name, rep["step_accesses"])
        assert set(rep["step_dispatches"]) == {STEP_DISPATCHES}, \
            (name, rep["step_dispatches"])
    # the warm phase's ledger continues the resident phase's
    charged = reps["repack"]["ledger"]["accesses"] \
        + reps["warm"]["ledger"]["accesses"]
    assert launches >= charged > 0, (launches, charged)
    for name, rep in reps.items():
        print(f"serve[{name}]: {rep['tok_s_steady']:.4f} tok/s steady, "
              f"p50 {rep['p50_ms']:.2f} ms, p99 {rep['p99_ms']:.2f} ms, "
              f"prefill {rep['prefill_ms_mean']:.1f} ms mean, "
              f"{rep['decode_steps']} decode steps, "
              f"{rep['total_accesses_per_token']} total accesses/token, "
              f"wall {rep['wall_s']:.2f} s")
    print(f"serve: {STEP_ACCESSES} accesses and {STEP_DISPATCHES} "
          f"dispatches every decode step; {launches} kernel launches "
          f"for {charged} ledger accesses; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")

    t = time.perf_counter()
    args = serve.parse_args(SERVE_ARGS)
    twin = model.derive(dataclasses.replace(model.cfg, cim_host_twin=True))
    serve.fresh_cim_state()
    twin_rep = serve.serve_once(twin, args)
    phases["twin_s"] = time.perf_counter() - t
    want = [r["token_ids"] for r in twin_rep["per_request"]]
    for name, rep in reps.items():
        got = [r["token_ids"] for r in rep["per_request"]]
        assert got == want, (name, got, want)
        assert all(len(tk) == args.gen for tk in got), got
    print(f"tokens: CiM phases == host twin: {want}")

    if profile:
        t = time.perf_counter()
        phase_profile(model, dev)
        phases["profile_s"] = time.perf_counter() - t

    print("phases: " + json.dumps({k: round(v, 3) for k, v in phases.items()}))
    entry = {"name": "fused_planes", "route": "cuda",
             "source": "src/repro_torch/cim/csrc/fused_planes.cu",
             "replaces": "src/repro/cim/fused_kernel.py:137",
             "launches": launches, "max_abs_err": kern["max_abs_err"],
             "ms": kern["ms"], "plain_ms": kern["plain_ms"],
             "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
             "library_ms": None}
    print(json.dumps({"kernels": [entry]}))
    print(f"gpu: {smi_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
