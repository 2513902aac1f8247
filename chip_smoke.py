#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py            # from the repository root, one H100

Phases, each fatal on failure (nothing is caught):
  1. build   — compile both kernels from the checkout, one nvcc each, in
               parallel: the fused bit-plane access
               (src/repro_torch/cim/csrc/fused_planes.cu) and the RG-LRU
               recurrence (src/repro_torch/kernels/csrc/rglru.cu), sm_90a;
               print each build time and the card's name and power limit;
  2. kernels — hold the fused kernel bit for bit against its plain PyTorch
               version over the op surface (every single op, the full op set
               and random subsets, n_bits 2-33, ragged widths, a tiled
               stack) and time both at the main path's largest access; hold
               the RG-LRU kernel against `rglru_ref` at (2,1,4096),
               (1,8,4096), (3,37,1000) and (1,2048,4096) in float32 and
               bfloat16, with and without h0, and time both at the decode
               shape and at (1,2048,4096);
  3. gemma   — gemma-2b at full width through the port's serve entry point
               (int8 CiM decode, streamed repack phase, resident phase, warm
               replay), asserting 2214 accesses and 90 dispatches per decode
               step and that the fused kernel's launches cover every access;
               the same request schedule through the quantized host twins
               must give identical greedy tokens;
  4. hybrid  — recurrentgemma-9b at full width the same way: 3154 accesses
               and 114 dispatches per decode step, RG-LRU launches = 26 x
               (decode steps + prefilled requests), tokens equal the host
               twin's; prints peak device memory and the array used.
The launch counts of each serve path are set to 0 just before it and read
just after; the kernel checks' own launches are not counted. Earlier lines
carry the metrics and one JSON `kernels` line; the last line is
{"ok": true, "device": {...}}. Without CUDA it exits non-zero and prints
no result. `--profile` adds a torch.profiler breakdown of one warm
resident decode step of each model.
"""
import dataclasses
import gc
import json
import os
import random
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SERVE = ["--preset", "full", "--device", "cuda", "--slots", "2",
         "--prompt-len", "8", "--cim-lower", "--cim-resident", "--assert-warm"]
#: per decode step at full width, 2 slots, prompt 8: every layer's CiM
#: contractions cost (2*8-1) + ceil(log2 K) accesses, one dispatch each
PATHS = {
    # 18 layers x [K = 2048, 2048, 16384 (MLP), 256 (QK^T), 16 (AV: Tmax 16)]
    "gemma-2b": dict(args=["--requests", "4", "--gen", "8"],
                     step_accesses=18 * (26 + 26 + 29 + 23 + 19),
                     step_dispatches=18 * 5),
    # 38 layers x [K = 4096, 4096, 12288 (MLP)]; local attention and the
    # RG-LRU blocks (26 of the 38 layers) are float
    "recurrentgemma-9b": dict(args=["--requests", "2", "--gen", "6"],
                              step_accesses=38 * (27 + 27 + 29),
                              step_dispatches=38 * 3),
}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
INT_OPS_PER_S = 67e12            # H100 SXM non-tensor 32-bit rate
F32_OPS_PER_S = 67e12            # H100 SXM float32 rate outside tensor cores
#: RG-LRU float operations per element (sigmoid x2 at 3 each, the decay
#: product, exp, a*a, 1-, max, sqrt, gate product, a*h + m*g at 3)
RGLRU_OPS_PER_ELEMENT = 16


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


def rglru_bounds(b: int, t: int, d: int, itemsize: int, h0: bool) -> dict:
    moved = 4 * b * t * d * itemsize + 4 * b * d * (2 if h0 else 1) + 4 * d
    ops = RGLRU_OPS_PER_ELEMENT * b * t * d
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": moved}


def phase_rglru(dev) -> dict:
    """The RG-LRU kernel against `rglru_ref` on the card. float32: y and h_T
    at atol 1e-5 (the reference's own tolerance). bfloat16 inputs: h_T at
    atol 1e-5 (both compute in float32); y within one bf16 rounding of the
    plain version's y, |dy| <= 2^-7 |y| + 1e-5 (the two float32 values,
    rounded to nearest even, can land on neighbouring bf16 values)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.ref import rglru_ref
    from repro_torch.kernels.rglru import rglru

    gen = torch.Generator(device=dev).manual_seed(1)
    max_err = 0.0
    cases = 0

    def inputs(shape, dtype, with_h0):
        b, _, d = shape
        x, r, i = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        ll = torch.randn((d,), generator=gen, device=dev)
        h0 = (torch.randn((b, d), generator=gen, device=dev)
              if with_h0 else None)
        return x, r, i, ll, h0

    for shape in ((2, 1, 4096), (1, 8, 4096), (3, 37, 1000), (1, 2048, 4096)):
        for dtype in (torch.float32, torch.bfloat16):
            for with_h0 in (False, True):
                args = inputs(shape, dtype, with_h0)
                y, h = rglru(*args)
                yp, hp = rglru_ref(*args)
                torch.cuda.synchronize()
                assert y.dtype == dtype and h.dtype == torch.float32
                h_err = float((h - hp).abs().max())
                dy = (y.float() - yp.float()).abs()
                y_err = float(dy.max())
                if dtype == torch.float32:
                    ok = y_err <= 1e-5
                else:
                    ok = bool((dy <= 2.0 ** -7 * yp.float().abs()
                               + 1e-5).all())
                if h_err > 1e-5 or not ok:
                    raise AssertionError(
                        f"rglru != plain at {shape} {dtype} h0={with_h0}: "
                        f"y {y_err}, h_T {h_err}")
                max_err = max(max_err, h_err, y_err)
                cases += 1

    # CUDA events around 10 launches time what a caller pays per call
    # (at the decode shape mostly the host's launch path); the profiler's
    # device rows give the kernel's own time per launch
    timings = {}
    for shape, with_h0 in (((2, 1, 4096), True), ((1, 2048, 4096), False)):
        args = inputs(shape, torch.bfloat16, with_h0)
        rounds = sorted(cuda_ms(lambda: rglru(*args), reps=10)
                        for _ in range(5))
        plain = sorted(cuda_ms(lambda: rglru_ref(*args), reps=2)
                       for _ in range(5))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                rglru(*args)
            torch.cuda.synchronize()
        dev_rows = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and "rglru_kernel" in e.key]
        device_ms = (sum(e.self_device_time_total for e in dev_rows) / 1e3
                     / max(1, sum(e.count for e in dev_rows)))
        bounds = rglru_bounds(*shape, 2, with_h0)
        timings[shape] = dict(ms=rounds[2], plain_ms=plain[2],
                              device_ms=device_ms, **bounds)
        print(f"rglru: {shape} bf16 h0={with_h0}: median {rounds[2]:.4f} ms "
              f"(rounds {rounds[0]:.4f}-{rounds[-1]:.4f}), device "
              f"{device_ms:.4f} ms per launch (profiler), plain median "
              f"{plain[2]:.4f} ms, bound {bounds['bound_ms']:.6f} ms "
              f"({bounds['bound_by']}, {bounds['bytes']} B)")
    print(f"rglru: {cases} cases within tolerance (max abs diff {max_err})")
    dec = timings[(2, 1, 4096)]
    return {"max_abs_err": max_err, "ms": dec["ms"],
            "device_ms": dec["device_ms"],
            "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
            "bound_by": dec["bound_by"], "shape": [2, 1, 4096], "cases": cases}


def phase_serve(arch: str, dev, profile: bool) -> dict:
    """One model at full width through `serve.main`: repack, resident and
    warm phases with their counts asserted, then the host twin's tokens."""
    import torch
    from repro_torch.cim import fused_kernel
    from repro_torch.configs import preset_config
    from repro_torch.kernels.rglru import rglru
    from repro_torch.launch import serve
    from repro_torch.models.model import build, with_cim

    spec = PATHS[arch]
    argv = ["--arch", arch] + SERVE + spec["args"]
    args = serve.parse_args(argv)
    times = {}
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    model = build(with_cim(preset_config(arch, args.preset), args.cim_bits),
                  device=dev, seed=args.seed)
    torch.cuda.synchronize()
    times["init_s"] = time.perf_counter() - t
    n_rec = model.kinds.count("rec")

    t = time.perf_counter()
    fused_kernel.fused_planes_op.launches = 0
    rglru.launches = 0
    out = serve.main(argv, model=model)
    fused_launches = fused_kernel.fused_planes_op.launches
    rglru_launches = rglru.launches
    times["serve_s"] = time.perf_counter() - t
    reps = out["phases"]
    for name, rep in reps.items():
        assert set(rep["step_accesses"]) == {spec["step_accesses"]}, \
            (arch, name, rep["step_accesses"])
        assert set(rep["step_dispatches"]) == {spec["step_dispatches"]}, \
            (arch, name, rep["step_dispatches"])
    # the warm phase's ledger continues the resident phase's
    charged = reps["repack"]["ledger"]["accesses"] \
        + reps["warm"]["ledger"]["accesses"]
    assert fused_launches >= charged > 0, (arch, fused_launches, charged)
    rglru_want = n_rec * sum(rep["decode_steps"] + rep["requests"]
                             for rep in reps.values())
    assert rglru_launches == rglru_want, (arch, rglru_launches, rglru_want)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    for name, rep in reps.items():
        print(f"{arch}[{name}]: {rep['tok_s_steady']:.4f} tok/s steady, "
              f"p50 {rep['p50_ms']:.2f} ms, p99 {rep['p99_ms']:.2f} ms, "
              f"prefill {rep['prefill_ms_mean']:.1f} ms mean, "
              f"{rep['decode_steps']} decode steps, "
              f"{rep['total_accesses_per_token']} total accesses/token, "
              f"wall {rep['wall_s']:.2f} s")
    print(f"{arch}: {spec['step_accesses']} accesses and "
          f"{spec['step_dispatches']} dispatches every decode step; "
          f"{fused_launches} fused launches for {charged} ledger accesses; "
          f"{rglru_launches} rglru launches; peak memory {peak_gib:.2f} GiB")

    t = time.perf_counter()
    twin = model.derive(dataclasses.replace(model.cfg, cim_host_twin=True))
    serve.fresh_cim_state()
    twin_rep = serve.serve_once(twin, args)
    times["twin_s"] = time.perf_counter() - t
    want = [r["token_ids"] for r in twin_rep["per_request"]]
    for name, rep in reps.items():
        got = [r["token_ids"] for r in rep["per_request"]]
        assert got == want, (arch, name, got, want)
        assert all(len(tk) == args.gen for tk in got), got
    print(f"{arch} tokens: CiM phases == host twin: {want}")
    if profile:
        t = time.perf_counter()
        phase_profile(model, dev, args.prompt_len + args.gen)
        times["profile_s"] = time.perf_counter() - t
    serve.fresh_cim_state()
    return {"fused_launches": fused_launches, "rglru_launches": rglru_launches,
            "peak_gib": peak_gib, "times": times}


def phase_profile(model, dev, max_len: int) -> None:
    """One warm resident decode step under torch.profiler: device time by
    PyTorch op and by ported kernel, and the device's idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve

    m = model.derive(dataclasses.replace(model.cfg, cim_resident=True),
                     resident_spec=serve.resident_array_spec(model.cfg, 2,
                                                             max_len))
    serve.fresh_cim_state()
    caches = m.init_caches(2, max_len)
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
    # key_averages() holds each kernel twice, as its own device row and in
    # the self device time of the PyTorch op that launched it; busy time
    # sums the device rows only (the ctypes kernels have no op above them)
    events = prof.key_averages()
    kernels = [(e.key, e.count, e.self_device_time_total / 1e3)
               for e in events if e.device_type == DeviceType.CUDA]
    ops = [(e.key, e.count, e.self_device_time_total / 1e3)
           for e in events if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    busy_ms = sum(r[2] for r in kernels)
    custom = [r for r in kernels
              if "fused_planes_kernel" in r[0] or "rglru_kernel" in r[0]]
    print(f"profile[{model.cfg.name}]: decode step wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms (idle share "
          f"{1 - busy_ms / wall_ms:.3f})")
    for name, count, ms in sorted(custom + ops, key=lambda r: -r[2])[:12]:
        print(f"profile:   {ms:9.2f} ms  x{count:<6d} {name[:90]}")
    serve.fresh_cim_state()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from repro_torch import kernel_build
    from repro_torch.cim import fused_kernel
    from repro_torch.kernels import rglru as rglru_mod

    profile = "--profile" in sys.argv[1:]
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases = {}

    t = time.perf_counter()
    sources = (fused_kernel.SOURCE, rglru_mod.SOURCE)
    build_s = kernel_build.compile_all(sources)
    for src in sources:
        kernel_build.load(src)
    phases["build_s"] = time.perf_counter() - t
    for src in sources:
        for line in kernel_build.BUILD_LOG.get(src.stem, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"nvcc[{src.stem}]: {line.strip()}")
        print(f"build: {kernel_build.library_path(src).name} in "
              f"{build_s[src.stem]:.2f} s")
    smi = smi_line()
    print(f"gpu: {smi}")

    t = time.perf_counter()
    kern = phase_kernel(dev)
    phases["kernel_s"] = time.perf_counter() - t
    t = time.perf_counter()
    rg = phase_rglru(dev)
    phases["rglru_s"] = time.perf_counter() - t

    runs = {}
    for arch in PATHS:
        t = time.perf_counter()
        runs[arch] = phase_serve(arch, dev, profile)
        phases[f"{arch}_s"] = time.perf_counter() - t
        for k, v in runs[arch]["times"].items():
            phases[f"{arch}_{k}"] = v
        gc.collect()
        torch.cuda.empty_cache()
    assert runs["gemma-2b"]["rglru_launches"] == 0

    print("phases: " + json.dumps({k: round(v, 3) for k, v in phases.items()}))
    fused = {"name": "fused_planes", "route": "cuda",
             "source": "src/repro_torch/cim/csrc/fused_planes.cu",
             "replaces": "src/repro/cim/fused_kernel.py:137",
             "launches": sum(r["fused_launches"] for r in runs.values()),
             "max_abs_err": kern["max_abs_err"],
             "ms": kern["ms"], "plain_ms": kern["plain_ms"],
             "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
             "library_ms": None}
    rec = {"name": "rglru", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/rglru.cu",
           "replaces": "src/repro/kernels/rglru.py:79",
           "launches": sum(r["rglru_launches"] for r in runs.values()),
           "max_abs_err": rg["max_abs_err"],
           "ms": rg["ms"], "plain_ms": rg["plain_ms"],
           "bound_ms": rg["bound_ms"], "bound_by": rg["bound_by"],
           "library_ms": None, "device_ms": rg["device_ms"],
           "shape": rg["shape"]}
    print(json.dumps({"kernels": [fused, rec]}))
    print(f"gpu: {smi_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
