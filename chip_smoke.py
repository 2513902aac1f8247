#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py            # from the repository root, one H100

Phases, each fatal on failure (nothing is caught):
  1. build   — compile the seven kernels from the checkout, one nvcc each,
               in parallel: the fused bit-plane access
               (src/repro_torch/cim/csrc/fused_planes.cu), the RG-LRU
               recurrence, TMA channel tiles (src/repro_torch/kernels/csrc/
               rglru_sm90.cu) and one thread per channel (csrc/rglru.cu), the
               sLSTM recurrence, persistent grid (src/repro_torch/kernels/
               csrc/slstm_sm90.cu) and one block per row (csrc/slstm.cu),
               and flash attention, SIMT (src/repro_torch/kernels/csrc/
               flash_attention.cu) and wgmma/TMA for bf16 (csrc/
               flash_attention_sm90.cu), sm_90a; print each build time, the
               registers and spills nvcc reports, and the card's name and
               power limit;
  2. kernels — hold the fused kernel bit for bit against its plain PyTorch
               version over the op surface (every single op, the full op set
               and random subsets, n_bits 2-33, ragged widths, a tiled
               stack) and time both at the main path's largest access; hold
               both RG-LRU kernels against `rglru_ref` at (2,1,4096),
               (1,8,4096), (3,37,1000), (1,2048,4096), (1,2040,4096),
               (2,2048,4096), (3,1000,1000), T at the routing threshold and
               at a tile edge +- 1, and a D that TMA cannot address, in
               float32 and bfloat16, with and without h0: the TMA kernel
               equal to the bit to the rows kernel, every routed call on
               the kernel `rglru.route` names by the launch counts; time both
               kernels and the plain version at the prefill and decode
               shapes, sweep the TMA kernel's channels, ring depth and gate
               warps, and both kernels over T; hold the sLSTM kernel that
               `slstm.route` picks against `slstm_ref` (TF32 off) at
               (3,32,64), (5,64,128), (2,48,256), (2,1,768), (1,512,768),
               (1,2048,768), (2,512,768), (4,64,768), (3,37,1500),
               (2,9,3000) and (1,5,7000), R and b in float32 and bfloat16,
               wx in float32 and bfloat16, with the default and a random
               initial state, asserting by the launch counts which kernel
               ran, and that a grid which cannot be co-resident is refused;
               time both kernels and the plain version at (2,1,768),
               (1,512,768) and (1,2048,768); hold flash attention against
               `mha_ref` (TF32 off), o and lse, on the reference test's four
               shapes, (1,2048,2048,8,1,256), (1,1000,1000,8,1,256),
               (2,37,300,4,2,128), (1,200,260,4,2,96) and
               (2,130,130,2,1,200), causal and not, float32 and bfloat16
               (bf16 o also by its relative L2 distance), asserting by the
               launch counts that every bf16 call went to the wgmma/TMA
               kernel and every float32 call to the SIMT one, and hold the
               SIMT kernel in bf16 too; time both kernels, the plain
               version and PyTorch's scaled_dot_product_attention (the
               library yardstick, never on the path) at gemma-2b's train
               shape;
  2b. banked — gemma-2b's decode contractions at full width (2 slots:
               the GeGLU MLP, d_model 2048 x 16384, lowered under policy
               "always", and through `mlp_cim`, whose default "edp" policy
               hosts the two up-projections on this array as the
               reference's plan does;
               QK^T and AV of 8x1 heads of 256 over 16 cached positions
               through `sdpa_cim`) on the paper's array (DEFAULT_SPEC: 4
               banks of 4 x 1024-word subarrays), cold and warm, against
               the same calls unbanked: outputs equal to the bit, words32
               equal, accesses and per-bank activations equal to the
               plan's closed form (planner steps x spec.plan(n).n_tiles,
               tiles dealt round-robin), warm dispatches equal, one kernel
               launch per logical access; the bank report printed; the same
               MLP under `set_current_spec(DEFAULT_SPEC.disable_bank(1))`
               with spec=None: bank 1 never charged, output unchanged; one
               access of 2^28 words (65536 tiles, the 8-token prefill
               up-projection's size) split over two launches, equal to the
               unbanked access; multiply, abs, relu, minimum, maximum,
               popcount, reduce_sum, dot and select at 2^24 words on the
               banked array against torch's integer ops and their plans;
               the largest decode access timed unbanked and banked (the
               kernel alone by CUDA events, in turns; the whole call under
               the profiler, with the tile/untile glue's share);
  2c. lower — the lowering compiler (`repro_torch.cim.lower`) on the card:
               gemma-2b's GeGLU MLP at full width (2 slots, d_model 2048,
               d_ff 16384) through `mlp_cim` (policy "edp") and under
               policy "always", streamed and resident: 3 regions, 3 warm
               dispatches, accesses equal to the summed region schedules,
               output equal to the bit to the plain `_mlp_quantized`;
               `sdpa_cim` at 8x1 heads of 256 over 16 cached positions: 2
               regions, 2 warm dispatches; `blockwise_attention_cim` over
               2048 kv positions in blocks of 512, causal and not: 2
               dispatches per block from two programs shared across
               blocks, equal to `blockwise_attention_quantized`; a seeded
               composed integer graph (elementwise, compare/select, mul,
               full sum, a contraction; int8 and int16) equal to torch's
               own integer ops, under the default policy and "never";
  2d. analog — the paper's FeFET device model on the card through the
               analog-oracle backend: the four level currents and the
               current and voltage margins against the same computed on the
               CPU (rtol 1e-5), the symmetric scheme's collapse; all 65536
               8-bit pairs through cim_add, cim_sub, cim_compare,
               cim_add_sub and the 16 Boolean functions in analog mode,
               equal to exact integers and to mode="boolean"; the main
               path's largest access (29 planes x 2^21 columns, seeded) with
               every op alone and all in one, the fused kernel equal to the
               bit to the device model, both timed; gemma-2b's decode MLP at
               full width through `mlp_cim(backend="analog-oracle")` equal
               to the fused backend's output and ledger, one `execute_tiled`
               access on the paper's array likewise; `analyze` of that MLP
               equal to its executed accesses;
  3. gemma   — gemma-2b at full width through the port's serve entry point
               (int8 CiM decode through `lower()`, streamed repack phase, resident phase, warm
               replay), asserting 2214 accesses and 90 dispatches per decode
               step and that the fused kernel's launches cover every access;
               the same request schedule through the quantized host twins
               must give identical greedy tokens; every serve phase prints
               the CUDA graphs it captured, their replays and the seconds
               spent capturing (each schedule program replays as one graph
               from its second call on);
  3a. graph-step — one warm resident gemma-2b decode step at full width
               replayed from CUDA graphs against the same step's eager
               body (`dispatch.eager_programs`): logits and tokens equal
               to the bit, the ledger field for field, 2214 accesses, 90
               dispatches, the fused launches and bytes equal; both
               steps' wall ms;
  3b. adra-faults — the paper's comparison on the card's kernel: `adra_sub`
               in one fused launch against `baseline_sub_then_cmp`'s two
               over 2^24 int16 words, both equal to `adra_int_ref` and to
               the torch-boolean backend, each timed with its kernel bytes,
               and the `adra_bitplane_op` shims against `adra_bitplane_ref`;
               gemma-2b at full width with `--sampler adra` (2 slots,
               prompt 8 + gen 4): every sampled batch equal to
               `adra_sample_ref` on the same logits, every decode step 2214
               + 18 accesses and 90 + 18 dispatches; the chaos serve (ECC
               pins, fault seed 0, resident BER 1e-9, scrub every 2 steps):
               tokens equal to the fault-free run, 0 uncorrected, corrected
               > 0, the ECC verify's ms per step and the peak memory; a
               bank of the serve's widened array killed at decode step 2:
               failover, tokens equal again;
  4. hybrid  — recurrentgemma-9b at full width the same way: 3154 accesses
               and 114 dispatches per decode step, RG-LRU launches = 26 x
               (decode steps + prefilled requests), each on the kernel
               `rglru.route` names, tokens equal the host twin's; prints
               peak device memory and the array used;
  4b. hybrid-prefill — the same model on the float path (no --cim-lower):
               3 requests of prompt 2040 + gen 8 (the 2048-token window) on
               2 slots: 26 x 3 prefill calls at (1,2040,4096) on the TMA
               RG-LRU kernel, decode calls on the kernel `rglru.route`
               names, nothing on the ledger; the prefill (eager, captured,
               replayed), decode and insert programs as CUDA graphs, tokens
               and launches equal to the run under `eager_programs()`;
               prints prefill ms, tok/s, peak memory, and one profiled
               prefill's RG-LRU device ms beside its wall time;
  5. xlstm   — xlstm-125m at full width through the same entry point on the
               float path (prompt 512, 16 tokens, 4 requests on 2 slots):
               every request completes, sLSTM launches = 3 x (decode steps +
               prefilled requests), every one on the persistent-grid
               kernel, the ledger charges 0 accesses and the
               fused and RG-LRU kernels launch 0 times; the prefill,
               decode (caches donated) and insert programs captured and
               replayed as CUDA graphs, tokens and launches equal to the
               run under `eager_programs()`; prints tok/s, p50/p99 (capture
               steps left out), prefill ms and peak device memory;
  6. agree   — the same xlstm-125m weights in float32 on the card and,
               copied, on the CPU (the plain versions): one 512-token
               prompt and 8 greedy decode steps give equal tokens and
               logits within atol 1e-3;
  7. train   — gemma-2b at full width through the port's train entry point
               (`repro_torch.launch.train`: 4 steps of batch 2 x 2048, 2
               microbatches, per-layer recomputation, under the
               Supervisor), with less than 1 GiB held at its start: finite
               losses, no restart, flash launches = 18 layers x 2
               microbatches x 2 (forward, recomputation) per step, every
               one on the wgmma/TMA kernel (bf16), no fused, RG-LRU or
               sLSTM launch; the step (state donated) captured as one CUDA
               graph at step 2 and replayed, losses equal to the bit to the
               same steps under `eager_programs()` from the same weights;
               prints step ms, tokens/s and peak device memory;
  8. train-agree — gemma's attention shape at 2 layers, d_model 512, vocab
               4096, float32 (so the SIMT flash kernel): the first batch's
               gradients and 2 train steps on the card and on the CPU from
               the same weights;
  9. configs — the registry's other families, one model at a time, each
               freed before the next and its peak memory printed:
               llama3.2-1b and deepseek-v2-lite-16b at full width through
               the serve entry point with --cim-lower (as phase 3: 1920 /
               80 and 81 / 3 accesses / dispatches a decode step, tokens
               equal the host twin's; deepseek's MoE layers and MLA run in
               float, only its dense layer 0 lowers); qwen3-14b,
               granite-3-8b, musicgen-large and internvl2-26b on the float
               path (the last two on seeded embed-stub inputs), built as
               `serve.main` builds them, bf16 layer weights only, 12 tokens
               a request: every request completes, 0 ledger accesses, 0
               kernel launches; llama3.2-1b training at full width (4
               steps of 2 x 2048, 32 flash launches a step, all on the
               wgmma/TMA kernel); the hybrid (3 layers) and xLSTM train
               cells (4 steps of 2 x 1024); reduced
               deepseek in float32 on the card against the CPU (prefill, 4
               greedy steps, first-batch loss and gradients, atol 1e-4).
               Every float serve and train cell here is graphed and held to
               its eager run, as in phases 5 and 7.
  10. mesh  — the mesh slice: (a) the geometry autotuner on gemma-2b's
               full-width decode MLP through `lower()` over
               DEFAULT_CANDIDATES, measured (predicted EDP per candidate,
               measured ms of replays only, `steady_ms` raising on a timed
               call that compiled; default and tuned ms, the winner and its
               launches; tuned <= default; a warm call searches nothing;
               the winners file round-trips); (b) a one-rank NCCL group
               and a (1,) "data" mesh: `execute_sharded` of the largest
               access and the MLP through `lower(mesh=)` on the paper's
               array, 3 calls each (each mesh program's eager first call,
               its capture as a CUDA graph with its all-gathers, a
               replay), every call equal to the unsharded call (planes,
               outputs, ledgers; 1 and 81 launches), each program captured
               once and replayed, the calls timed; (c) a (1, 1) mesh:
               llama3.2-1b trained through the train entry point on
               DTensor state (4 steps of 2 x 2048: the step program eager,
               captured with its collectives at the second step and
               replayed; losses equal to phase 9's to 1e-6, and losses,
               grad norms, lrs and launches to the bit to the same steps
               under `eager_programs()`; 32 flash launches a step on the
               wgmma/TMA kernel, peak memory), and `moe_apply_ep` of one
               full-width
               deepseek-v2-lite-16b layer (4096 tokens) equal to
               `moe_apply`'s routed output; (d) one dry-run cell
               (llama3.2-1b x decode_32k on a 256-rank fake group), its
               roofline against the H100 row and its seconds; (e) the
               kernels at a tensor-parallel rank's shapes: the RG-LRU
               kernel on each of the 16 and of the 2 channel blocks of a
               (1, 2040, 4096) bf16 input, and bf16 flash on each rank's
               head block at gemma-2b's and llama3.2-1b's train shapes
               (MESH_RANK_FLASH), equal to the bit to the whole-width call's
               columns and heads, every block on the sm90 kernel by
               `route`, and each block timed (these are checks: their
               launches are not counted).
The launch counts of each serve, banked, analog MLP, adra-faults, train,
configs and mesh path are set to 0 just before it and read just after; the kernel checks'
and timings' own launches are not counted. Earlier lines
carry the metrics and one JSON `kernels` line; the last line is
{"ok": true, "device": {...}}. Without CUDA it exits non-zero and prints
no result. `--tp-cards` runs instead the sharded train step across 2
and 4 cards (`phase_tp_cards`: one process a card, NCCL; the
tensor-parallel step's losses held to one card's, each rank's step
program captured with its collectives and replayed, equal to the bit to
its eager run; `--tp-cards --src DIR` times another port's steps), and
`--mesh-cells [--src DIR]` only the mesh programs' timings on one card
(`phase_mesh_cells`); two processes on one
card cannot run it, as gloo's functional all-gather of CUDA tensors
(`torch.ops._c10d_functional.all_gather_into_tensor`, which DTensor and
`sharding.rules.tp_gather` use) crashes the process in torch 2.11.
`--profile` adds a torch.profiler breakdown of one warm
resident decode step of gemma-2b and recurrentgemma-9b (with the fused
kernel's summed byte bound over the step; the step replays its programs'
graphs, and the fused kernel's rows in the trace are held against its
counted launches), of one xlstm-125m decode step and of one gemma-2b
train step, with the peak device memory. `--cells` runs instead only the
cells whose timing the float step graphs and the steady windows move
(`phase_cells`: the float serve and train cells, deepseek-v2-lite-16b's
CiM serve and the autotuner, through the entry points alone, no check of
graphs), and `--cells --src DIR` runs them on the port under DIR (another
checkout's `src`, such as the parent commit's, unpacked into a directory
the repository ignores), so that two versions compare in one call on one
card.
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
SRC = os.path.join(ROOT, "src")
if "--src" in sys.argv[1:]:
    SRC = os.path.abspath(sys.argv[sys.argv.index("--src") + 1])
sys.path.insert(0, SRC)

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
#: RG-LRU special-function operations per element (3 exponentials, 2
#: reciprocals, 1 square root) at the H100's 16 a clock per SM on 132 SMs,
#: times the card's `clocks.max.sm` from nvidia-smi
RGLRU_SFU_PER_ELEMENT = 6
SFU_PER_CLOCK_SM = 16
H100_SMS = 132
#: RG-LRU cases (B, T, D) held on both kernels: decode, the CiM hybrid's
#: prefill at 8, a ragged one, the model's prefill at 2048 and at 2040 (the
#: float prefill phase's), two rows, ragged T and D at once, T at the
#: routing threshold (8) and at a tile edge (64) +- 1, and D = 1001 (whose
#: float32 and bf16 rows TMA cannot address: the rows kernel only)
RGLRU_CASES = [(2, 1, 4096), (1, 8, 4096), (3, 37, 1000), (1, 2048, 4096),
               (1, 2040, 4096), (2, 2048, 4096), (3, 1000, 1000),
               (2, 7, 512), (2, 8, 512), (2, 9, 512), (1, 63, 1024),
               (1, 64, 1024), (1, 65, 1024), (2, 40, 1001)]
#: the RG-LRU shapes timed (bf16; h0 at decode only, as the model calls)
RGLRU_TIMED = [((1, 2048, 4096), False), ((1, 2040, 4096), False),
               ((2, 2048, 4096), False), ((2, 1, 4096), True)]
#: sLSTM float operations per channel and step besides the h R product:
#: 8 adds for the pre-activations, tanh, log-sigmoid and sigmoid (about 12),
#: the stabilizer and its two exponentials (6), the c, n, h updates (7)
SLSTM_GATE_OPS = 33
BF16_TC_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate
#: flash attention shapes (B, Tq, Tk, Hq, Hkv, D): the reference test's
#: four (tests/test_kernels.py:90-115), then gemma-2b's train shape,
#: llama3.2-1b's (the configs phase's training: D = 64 over many key tiles,
#: 32 q heads over 8 kv heads), a ragged one, one with Tq < Tk, and two
#: head widths that are not a whole number of 64-column boxes (the
#: wgmma/TMA kernel pads D = 96 to 128 and D = 200 to 256 by the box's
#: zero fill)
FLASH_REF_SHAPES = [(1, 128, 128, 4, 4, 64), (2, 128, 128, 4, 2, 64),
                    (1, 256, 256, 8, 1, 64), (1, 64, 192, 4, 2, 32)]
FLASH_TRAIN_SHAPE = (1, 2048, 2048, 8, 1, 256)
FLASH_LLAMA_TRAIN_SHAPE = (2, 2048, 2048, 32, 8, 64)
FLASH_WIDE_SHAPES = [FLASH_TRAIN_SHAPE, FLASH_LLAMA_TRAIN_SHAPE,
                     (1, 1000, 1000, 8, 1, 256),
                     (2, 37, 300, 4, 2, 128), (1, 200, 260, 4, 2, 96),
                     (2, 130, 130, 2, 1, 200)]
#: bfloat16 o's relative L2 distance from the plain version, ||o - want|| /
#: ||want||, on every bfloat16 case: the per-element 2e-2 is about half of
#: a typical |o| at 2048 keys, so a fault that moves whole rows by tens of
#: percent can pass it. Rounding o to bfloat16 alone gives about 2^-9 /
#: sqrt(3) (1.1e-3), and p in bfloat16 less than that
FLASH_BF16_REL_L2 = 1e-2
#: the xlstm-125m serve of the smoke (the float path: no --cim-lower)
XLSTM_SERVE = ["--arch", "xlstm-125m", "--preset", "full", "--device",
               "cuda", "--slots", "2", "--requests", "4", "--prompt-len",
               "512", "--gen", "16"]
#: the hybrid's float-path prefill: prompt + gen = the 2048-token window;
#: 3 requests, so that the third prefill replays the graph the second
#: captured
HYBRID_PREFILL = ["--arch", "recurrentgemma-9b", "--preset", "full",
                  "--device", "cuda", "--slots", "2", "--requests", "3",
                  "--prompt-len", "2040", "--gen", "8"]
#: the train phase: gemma-2b at full width, microbatches 2 and remat from
#: its config; a checkpoint (40 GB) never falls due
TRAIN = ["--arch", "gemma-2b", "--preset", "full", "--device", "cuda",
         "--steps", "4", "--batch", "2", "--seq", "2048", "--ckpt-every",
         "1000", "--log-every", "1"]
#: words each of the remaining macros runs on in the banked phase
BANKED_MACRO_WORDS = 1 << 24
#: card-vs-CPU logits tolerance of the float32 xlstm-125m agreement: both
#: compute in float32 and differ only in summation order, which 12 layers
#: and a 512-step recurrence carry; measured differences are printed
AGREE_ATOL = 1e-3


def smi_line(fields: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
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


def bank_closed_form(n_tiles: int, live) -> dict:
    """Activations per physical bank of one access of `n_tiles` tiles dealt
    round-robin over the live banks: slot s takes the tiles t % n == s."""
    n = len(live)
    return {b: (n_tiles - s + n - 1) // n for s, b in enumerate(live)
            if (n_tiles - s + n - 1) // n}


def phase_banked(dev) -> dict:
    """gemma-2b's decode contractions at full width on the paper's banked
    array, against the same calls unbanked: outputs to the bit, ledger
    counts against the plan's closed form, warm dispatches and kernel
    launches; a degraded spec installed process-wide; one access over the
    65535-tile launch limit; the remaining macros at 2^24 words; the
    largest decode access timed banked and unbanked."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.cim import array, dispatch, engine, fused_kernel, macro
    from repro_torch.cim import planner
    from repro_torch.cim.accounting import LEDGER
    from repro_torch.cim.lower import lower
    from repro_torch.cim.planepack import PlanePack
    from repro_torch.configs import preset_config
    from repro_torch.models import attention, layers

    cfg = preset_config("gemma-2b", "full")
    spec = array.DEFAULT_SPEC
    fused = fused_kernel.fused_planes_op
    gen = torch.Generator(device=dev).manual_seed(0)
    act = cfg.activation_dtype()
    p = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gating, act, dev)
    x = torch.randn((2, 1, cfg.d_model), generator=gen, device=dev).to(act)
    slots, t_max = 2, 16
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn((slots, 1, hq, hd), generator=gen, device=dev).to(act)
    k = torch.randn((slots, t_max, hkv, hd), generator=gen, device=dev).to(act)
    v = torch.randn((slots, t_max, hkv, hd), generator=gen, device=dev).to(act)
    pos = torch.tensor([7, 12], device=dev)
    mask = (torch.arange(t_max, device=dev)[None, :] <= pos[:, None])[:, None]
    scale = 1.0 / hd ** 0.5

    def kpad(n):
        return 1 << planner._log2_ceil(n)

    # (logical steps, words) of every schedule, from the planner alone
    g = hq // hkv
    mlp_plans = [(planner.plan_matmul(kk, nn).accesses, slots * kpad(kk) * nn)
                 for kk, nn in ((cfg.d_model, cfg.d_ff),
                                (cfg.d_model, cfg.d_ff),
                                (cfg.d_ff, cfg.d_model))]
    attn_plans = [(planner.plan_batched_matmul(slots * hkv, kk, nn).accesses,
                   slots * hkv * g * kpad(kk) * nn)
                  for kk, nn in ((hd, t_max), (t_max, hd))]
    out = {"launches": 0, "cases": {}}

    def run(name, fn, plans, banked_spec, live):
        """fn() twice (cold, warm) with its ledger, dispatches and launches;
        asserts the closed forms when placed on `banked_spec`."""
        res = []
        for _ in range(2):
            LEDGER.reset()
            d0 = dispatch.cache_stats()["dispatches"]
            fused.launches = 0
            y = fn()
            torch.cuda.synchronize()
            res.append({"y": y, "launches": fused.launches,
                        "dispatches": dispatch.cache_stats()["dispatches"]
                        - d0, "accesses": LEDGER.accesses,
                        "words32": LEDGER.words32,
                        "banks": dict(LEDGER.bank_accesses)})
        steps = sum(a for a, _ in plans)
        if banked_spec is not None:
            want = sum(a * banked_spec.plan(nw).n_tiles for a, nw in plans)
            want_banks: dict = {}
            for a, nw in plans:
                tiles = banked_spec.plan(nw).n_tiles
                for b, c in bank_closed_form(tiles, live).items():
                    want_banks[(0, b)] = want_banks.get((0, b), 0) + a * c
            for r in res:
                assert r["accesses"] == want, (name, r["accesses"], want)
                assert r["banks"] == want_banks, (name, r["banks"])
            # one launch per logical access below the launch's tile limit
            want_launches = sum(
                a * -(-banked_spec.plan(nw).n_tiles
                      // fused_kernel.MAX_TILES_PER_LAUNCH) for a, nw in plans)
        else:
            want = want_launches = steps
            for r in res:
                assert r["accesses"] == want and \
                    r["banks"] == {(0, 0): want}, (name, r)
        for r in res:
            assert r["launches"] == want_launches, (name, r["launches"])
        assert torch.equal(res[0]["y"], res[1]["y"]), name
        return res

    # every contraction placed: the lowered MLP under policy "always"; under
    # the default "edp" the cost model hosts the two up-projections on this
    # array (their stride-N reductions cross banks on most steps), as the
    # reference's plan does, and mlp_cim lowers only the down-projection
    always = lower(lambda p_, x_: layers._mlp_quantized(p_, x_, cfg.gating,
                                                        8),
                   spec=spec, policy="always")
    t = time.perf_counter()
    flat_mlp = run("mlp unbanked", lambda: layers.mlp_cim(
        p, x, cfg.gating), mlp_plans, None, None)
    bank_mlp = run("mlp banked", lambda: always(p, x), mlp_plans, spec,
                   spec.enabled_banks)
    edp_plans = mlp_plans[2:]
    edp = layers._lowered_mlp(cfg.gating, 8, None, spec).trace(p, x)
    assert [(v.name, v.words) for v in edp.offload_plan.verdicts
            if v.index in edp.offload_plan.demoted] == \
        [("dot_general", mlp_plans[0][1])] * 2, edp.describe()
    bank_edp = run("mlp banked edp", lambda: layers.mlp_cim(
        p, x, cfg.gating, spec=spec), edp_plans, spec, spec.enabled_banks)
    assert torch.equal(bank_edp[0]["y"], flat_mlp[0]["y"])
    out["launches"] += bank_edp[0]["launches"] + bank_edp[1]["launches"]
    out["cases"]["mlp edp"] = {
        "accesses": bank_edp[0]["accesses"],
        "launches": bank_edp[0]["launches"],
        "demoted": edp.offload_plan.demoted_eqns,
        "margins": [v.margin for v in edp.offload_plan.verdicts
                    if v.index in edp.offload_plan.demoted]}
    print(f"banked[mlp edp]: the cost model hosts "
          f"{edp.offload_plan.demoted_eqns} of 3 contractions on this array "
          f"(margins {out['cases']['mlp edp']['margins']}); "
          f"{bank_edp[0]['accesses']} accesses, output equal to the "
          f"unbanked call's")
    flat_att = run("sdpa unbanked", lambda: attention.sdpa_cim(
        q, k, v, mask, scale, n_bits=8), attn_plans, None, None)
    bank_att = run("sdpa banked", lambda: attention.sdpa_cim(
        q, k, v, mask, scale, n_bits=8, spec=spec), attn_plans, spec,
        spec.enabled_banks)
    for flat, bank, name in ((flat_mlp, bank_mlp, "mlp"),
                             (flat_att, bank_att, "sdpa")):
        assert torch.equal(bank[0]["y"], flat[0]["y"]), name
        assert torch.isfinite(bank[0]["y"].float()).all(), name
        assert bank[0]["words32"] == flat[0]["words32"], name
        assert bank[1]["dispatches"] == flat[1]["dispatches"], name
        out["launches"] += bank[0]["launches"] + bank[1]["launches"]
        out["cases"][name] = {
            "accesses": bank[0]["accesses"], "launches": bank[0]["launches"],
            "warm_dispatches": bank[1]["dispatches"],
            "unbanked_accesses": flat[0]["accesses"]}
        print(f"banked[{name}]: output equal to the unbanked call's; "
              f"{bank[0]['accesses']} accesses (unbanked "
              f"{flat[0]['accesses']}), per bank "
              f"{sorted(bank[0]['banks'].items())}, words32 "
              f"{bank[0]['words32']}, {bank[0]['launches']} launches, warm "
              f"dispatches {bank[1]['dispatches']}")
    LEDGER.reset()
    always(p, x)
    print(f"banked[mlp]: bank_report {json.dumps(LEDGER.bank_report(spec))}")
    out["mlp_s"] = time.perf_counter() - t

    # a degraded array installed process-wide: spec=None follows it
    dead = spec.disable_bank(1)
    array.set_current_spec(dead)
    try:
        deg = run("mlp degraded", lambda: layers.mlp_cim(p, x, cfg.gating),
                  edp_plans, dead, dead.enabled_banks)
    finally:
        array.set_current_spec(None)
    assert all(b != 1 for _d, b in deg[0]["banks"]), deg[0]["banks"]
    assert torch.equal(deg[0]["y"], flat_mlp[0]["y"])
    out["launches"] += deg[0]["launches"] + deg[1]["launches"]
    print(f"banked[degraded, bank 1 dead]: output unchanged; per bank "
          f"{sorted(deg[0]['banks'].items())}")

    # one access over the launch's tile limit: the 8-token prefill
    # up-projection's size, 8 x 2048 x 16384 = 2^28 words, 65536 tiles
    n_words = 8 * cfg.d_model * cfg.d_ff
    big = [PlanePack(planes=torch.randint(
        -2 ** 31, 2 ** 31, (16, n_words // 32), dtype=torch.int32,
        device=dev, generator=gen), n_bits=16, signed=True,
        shape=(n_words,)) for _ in range(2)]
    tiles = spec.plan(n_words).n_tiles
    assert tiles > fused_kernel.MAX_TILES_PER_LAUNCH, tiles
    want = engine.execute(big[0], big[1], ("add", "lt"))
    fused.launches = 0
    LEDGER.reset()
    got = dispatch.execute_tiled(big[0], big[1], ("add", "lt"), spec=spec)
    torch.cuda.synchronize()
    split = fused.launches
    assert split == -(-tiles // fused_kernel.MAX_TILES_PER_LAUNCH), split
    assert LEDGER.accesses == tiles
    for op in ("add", "lt"):
        assert torch.equal(got[op].planes, want[op].planes), op
    out["launches"] += split
    out["cap"] = {"words": n_words, "tiles": tiles, "launches": split}
    print(f"banked[cap]: {n_words} words, {tiles} tiles in {split} launches, "
          f"equal to the unbanked access")
    del big, want, got

    # the remaining macros at 2^24 words on the banked spec
    n = BANKED_MACRO_WORDS
    xi = torch.randint(-128, 128, (n,), dtype=torch.int32, device=dev,
                       generator=gen)
    yi = torch.randint(-128, 128, (n,), dtype=torch.int32, device=dev,
                       generator=gen)
    si = torch.randint(-8, 8, (n,), dtype=torch.int32, device=dev,
                       generator=gen)
    px, py = PlanePack.pack(xi, 8), PlanePack.pack(yi, 8)
    bits = sum(((xi >> i) & 1) for i in range(8))
    pred = engine.execute(px, py, ("lt",))["lt"]
    cases = [
        ("multiply", lambda: macro.multiply(px, py, spec=spec).unpack(),
         xi * yi, planner.plan_multiply(8, 8), n),
        ("abs_", lambda: macro.abs_(px, spec=spec).unpack(), xi.abs(),
         planner.plan_abs(8), n),
        ("relu", lambda: macro.relu(px, spec=spec).unpack(),
         xi.clamp(min=0), planner.plan_relu(8), n),
        ("minimum", lambda: macro.minimum(px, py, spec=spec).unpack(),
         torch.minimum(xi, yi), planner.plan_minimum(8), n),
        ("maximum", lambda: macro.maximum(px, py, spec=spec).unpack(),
         torch.maximum(xi, yi), planner.plan_maximum(8), n),
        ("popcount", lambda: macro.popcount(px, spec=spec).unpack(), bits,
         planner.plan_popcount(8), n),
        ("reduce_sum", lambda: macro.reduce_sum(px, spec=spec).unpack(),
         xi.sum(), planner.plan_reduce_sum(n, n_bits=8), n),
        ("dot", lambda: macro.dot(si, si.flip(0), spec=spec),
         (si.long() * si.flip(0).long()).sum(), planner.plan_dot(n), n),
        ("select", lambda: macro.select(pred, px, py).unpack(),
         torch.where(xi < yi, xi, yi), None, n),
    ]
    for name, fn, want_v, plan, nw in cases:
        LEDGER.reset()
        fused.launches = 0
        got_v = fn()
        torch.cuda.synchronize()
        assert torch.equal(got_v.long(), want_v.long()), name
        want_acc = 0 if plan is None else plan.placed(spec, nw).placed_accesses
        assert LEDGER.accesses == want_acc, (name, LEDGER.accesses, want_acc)
        out["launches"] += fused.launches
        out["cases"][name] = {"accesses": LEDGER.accesses,
                              "launches": fused.launches}
    print("banked[macros, 2^24 words]: " + ", ".join(
        f"{c[0]} {out['cases'][c[0]]['accesses']}" for c in cases)
        + " accesses, each equal to torch's integer op and to its plan")
    del px, py, xi, yi, si, bits, pred

    # the largest decode access, [2, 16384, 2048] words at 29 planes
    n_bits, w, ops = 29, (2 * cfg.d_ff * cfg.d_model) // 32, ("add",)
    pa, pb = (PlanePack(planes=torch.randint(
        -2 ** 31, 2 ** 31, (n_bits, w), dtype=torch.int32, device=dev,
        generator=gen), n_bits=n_bits, signed=True, shape=(32 * w,))
        for _ in range(2))
    plan = spec.plan(32 * w)
    ta, tb = dispatch._tile(pa.planes, plan), dispatch._tile(pb.planes, plan)
    lanes = plan.lanes_per_tile

    def median_ms(fn):
        return sorted(cuda_ms(fn, reps=10) for _ in range(5))[2]

    times = {}                  # in turns: unbanked, banked, banked, unbanked
    for name, fn in (("unbanked", lambda: fused(pa.planes, pb.planes, ops)),
                     ("banked", lambda: fused(ta, tb, ops)),
                     ("banked_again", lambda: fused(ta, tb, ops)),
                     ("unbanked_again",
                      lambda: fused(pa.planes, pb.planes, ops))):
        times[name] = median_ms(fn)
    assert torch.equal(dispatch._untile(fused(ta, tb, ops)[0], w),
                       fused(pa.planes, pb.planes, ops)[0])

    def profiled(fn):
        """Per-call device ms (median of 5 profiled calls): the fused
        kernel and everything the call ran on the device."""
        kern, busy = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            rows = [(e.key, e.self_device_time_total / 1e3)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and not e.is_user_annotation]
            kern.append(sum(ms for key, ms in rows
                            if "fused_planes_kernel" in key))
            busy.append(sum(ms for _, ms in rows))
        return statistics.median(kern), statistics.median(busy)

    flat_k, flat_b = profiled(lambda: engine.execute(pa, pb, ops))
    bank_k, bank_b = profiled(lambda: dispatch.execute_tiled(pa, pb, ops,
                                                             spec=spec))
    bounds = kernel_bounds(n_bits, w, ops)
    out["timing"] = {"shape": [n_bits, w, list(ops)], "tiles": plan.n_tiles,
                     "lanes_per_tile": lanes, "events_ms": times,
                     "profiled_unbanked_kernel_ms": flat_k,
                     "profiled_unbanked_busy_ms": flat_b,
                     "profiled_banked_kernel_ms": bank_k,
                     "profiled_banked_busy_ms": bank_b,
                     "banked_glue_share": 1 - bank_k / bank_b,
                     "bound_ms": bounds["bound_ms"]}
    print(f"banked[time]: largest decode access ({n_bits} planes, {32 * w} "
          f"words, {plan.n_tiles} tiles of {lanes} lanes), kernel median "
          f"ms: " + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
          + f"; bound {bounds['bound_ms']:.4f}")
    print(f"banked[time]: profiled call, device ms (median of 5): unbanked "
          f"kernel {flat_k:.4f} of {flat_b:.4f} busy; banked kernel "
          f"{bank_k:.4f} of {bank_b:.4f} busy, tile/untile glue share "
          f"{1 - bank_k / bank_b:.3f}")
    del pa, pb, ta, tb
    gc.collect()
    torch.cuda.empty_cache()
    return out


#: the lower phase's composed graph: int8 and int16 operands of this many
#: words, and an int8 contraction [M, K] x [K, N]
LOWER_GRAPH_WORDS = 1 << 16
LOWER_GRAPH_MKN = (64, 256, 64)
#: the lower phase's blockwise attention: (query tokens, kv positions,
#: kv block)
LOWER_BLOCKWISE = (16, 2048, 512)


def composed_graph(seed: int, dtype):
    """A seeded random integer graph over three operands of `dtype`:
    elementwise ops, compare + select, mul, a full sum rebroadcast, an
    int->int convert round trip and bitwise not, then an int8 contraction
    (int32 result) and its bias add. Returns the function."""
    import torch
    from repro_torch.cim.trace import int_contract

    rng = random.Random(seed)
    steps = [(rng.randrange(10), rng.randrange(10_000)) for _ in range(8)]

    def fn(a, b, c, x, w):
        vals = [a, b, c]
        for kind, sel in steps:
            u = vals[sel % len(vals)]
            v = vals[(sel // 7) % len(vals)]
            if kind == 0:
                r = u + v
            elif kind == 1:
                r = u - v
            elif kind == 2:
                r = u * v
            elif kind == 3:
                r = u ^ v
            elif kind == 4:
                r = torch.minimum(u, v)
            elif kind == 5:
                r = torch.maximum(u, v)
            elif kind == 6:
                cmp = (u < v, u <= v, u > v, u >= v, u == v, u != v)[sel % 6]
                r = torch.where(cmp, u, v)
            elif kind == 7:
                r = u + torch.sum(u, dtype=dtype)
            elif kind == 8:
                r = ~u.to(torch.int8).to(dtype)
            else:
                r = torch.abs(u)
            vals.append(r)
        y = int_contract(x, w)
        return vals[-1], vals[-2], y + torch.sum(y, dtype=torch.int32)

    return fn


def phase_lower(dev) -> dict:
    """The lowering compiler on the card: gemma-2b's GeGLU MLP at full
    width through `mlp_cim` (the default "edp" policy) and under "always",
    streamed and resident; `sdpa_cim` at gemma-2b's heads over 16 cached
    positions; `blockwise_attention_cim` over 2048 kv positions in blocks
    of 512, causal and not; a composed integer graph in int8 and int16
    against torch's own integer ops, with policy "never" too. Region counts,
    warm dispatches and accesses against the capture's plan; outputs to the
    bit against the plain functions on the card."""
    import torch

    from repro_torch.cim import cost, dispatch, fused_kernel, planner
    from repro_torch.cim.accounting import LEDGER
    from repro_torch.cim.lower import lower
    from repro_torch.configs import preset_config
    from repro_torch.launch import serve
    from repro_torch.models import attention, layers
    from repro_torch.models.blockwise_attention import (
        blockwise_attention_cim, blockwise_attention_quantized)
    from repro_torch.models.model import with_cim

    fused = fused_kernel.fused_planes_op
    cfg = preset_config("gemma-2b", "full")
    gen = torch.Generator(device=dev).manual_seed(1)
    act = cfg.activation_dtype()
    p = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gating, act, dev)
    x = torch.randn((2, 1, cfg.d_model), generator=gen, device=dev).to(act)
    out = {"launches": 0, "cases": {}}

    def calls(name, fn, n_calls=2):
        """fn() cold then warm: results, ledger accesses, dispatches,
        misses, resident pins/hits and wall ms of each call."""
        res = []
        for _ in range(n_calls):
            LEDGER.reset()
            c0 = dispatch.cache_stats()
            fused.launches = 0
            t = time.perf_counter()
            y = fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            c1 = dispatch.cache_stats()
            out["launches"] += fused.launches
            res.append({"y": y, "ms": ms, "accesses": LEDGER.accesses,
                        "launches": fused.launches,
                        **{k: c1[k] - c0[k] for k in (
                            "dispatches", "misses", "resident_pins",
                            "resident_hits")}})
        return res

    def record(name, res, regions, **extra):
        out["cases"][name] = dict(
            regions=regions, accesses=res[0]["accesses"],
            launches=res[0]["launches"],
            cold_dispatches=res[0]["dispatches"],
            warm_dispatches=res[1]["dispatches"],
            warm_misses=res[1]["misses"], cold_ms=res[0]["ms"],
            warm_ms=res[1]["ms"], **extra)
        print(f"lower[{name}]: {regions} regions, {res[0]['accesses']} "
              f"accesses, {res[0]['launches']} launches, dispatches cold "
              f"{res[0]['dispatches']} / warm {res[1]['dispatches']} (warm "
              f"misses {res[1]['misses']}), wall ms cold {res[0]['ms']:.2f} "
              f"/ warm {res[1]['ms']:.2f}"
              + "".join(f", {k} {v}" for k, v in extra.items()))

    # -- gemma-2b's MLP: edp (mlp_cim) and always, streamed and resident --
    twin = layers._mlp_quantized(p, x, cfg.gating, 8)
    mlp_steps = 2 * planner.plan_matmul(cfg.d_model, cfg.d_ff).accesses \
        + planner.plan_matmul(cfg.d_ff, cfg.d_model).accesses
    cost.reset_plan_stats()
    rspec = serve.resident_array_spec(with_cim(cfg, 8), 2, 16)
    for policy in ("edp", "always"):
        for resident in (False, True):
            name = f"mlp {policy}" + (" resident" if resident else "")
            if policy == "edp":
                fn = lambda: layers.mlp_cim(   # noqa: E731
                    p, x, cfg.gating, resident=resident, resident_spec=rspec)
                lf = layers._lowered_mlp(
                    cfg.gating, 8, None, None, resident,
                    layers._resident_set(resident, rspec))
            else:
                lf = lower(lambda p_, x_: layers._mlp_quantized(
                    p_, x_, cfg.gating, 8), policy="always",
                    resident_argnums=(0,) if resident else (),
                    resident_set=layers._resident_set(resident, rspec))
                fn = lambda: lf(p, x)          # noqa: E731
            comp = lf.trace(p, x)
            res = calls(name, fn)
            planned = sum(r.schedule.accesses for r in comp.regions)
            assert len(comp.regions) == 3, (name, comp.describe())
            assert comp.offload_plan.demoted_eqns == 0, comp.describe()
            for r in res:
                assert torch.equal(r["y"], twin), name
                assert r["accesses"] == planned == mlp_steps, \
                    (name, r["accesses"], planned)
            assert res[1]["dispatches"] == 3 and res[1]["misses"] == 0, \
                (name, res[1])
            if resident:
                assert res[0]["resident_pins"] == 3, (name, res[0])
                assert res[1]["resident_hits"] == 3 and \
                    res[1]["resident_pins"] == 0, (name, res[1])
            record(name, res, len(comp.regions),
                   pins=res[0]["resident_pins"],
                   warm_hits=res[1]["resident_hits"])
    out["plan_stats"] = dict(cost.PLAN_STATS)
    print(f"lower[mlp]: offload plan stats {json.dumps(cost.PLAN_STATS)}")
    del twin
    serve.fresh_cim_state()

    # -- sdpa_cim at gemma-2b's 8x1 heads of 256 over 16 cached positions -
    slots, t_max = 2, 16
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn((slots, 1, hq, hd), generator=gen, device=dev).to(act)
    k = torch.randn((slots, t_max, hkv, hd), generator=gen, device=dev).to(act)
    v = torch.randn((slots, t_max, hkv, hd), generator=gen, device=dev).to(act)
    pos = torch.tensor([7, 12], device=dev)
    mask = (torch.arange(t_max, device=dev)[None, :] <= pos[:, None])[:, None]
    scale = 1.0 / hd ** 0.5
    want = attention._sdpa_quantized(q, k, v, mask, scale)
    res = calls("sdpa", lambda: attention.sdpa_cim(q, k, v, mask, scale))
    qs = q.float() * scale
    comp = attention._lowered_sdpa(8, None, None).trace(qs, k, v, mask)
    assert len(comp.regions) == 2, comp.describe()
    for r in res:
        assert torch.equal(r["y"], want)
        assert r["accesses"] == comp.accesses
    assert res[1]["dispatches"] == 2 and res[1]["misses"] == 0, res[1]
    record("sdpa", res, len(comp.regions))

    # -- blockwise over 2048 kv positions in blocks of 512 -----------------
    tq, tk, bk = LOWER_BLOCKWISE
    qb = torch.randn((1, tq, hq, hd), generator=gen, device=dev)
    kb = torch.randn((1, tk, hkv, hd), generator=gen, device=dev)
    vb = torch.randn((1, tk, hkv, hd), generator=gen, device=dev)
    for causal in (True, False):
        name = f"blockwise causal={causal}"
        want = blockwise_attention_quantized(qb, kb, vb, causal=causal,
                                             block_k=bk)
        res = calls(name, lambda: blockwise_attention_cim(
            qb, kb, vb, causal=causal, block_k=bk))
        for r in res:
            assert torch.equal(r["y"], want), name
            assert r["dispatches"] == 2 * (tk // bk), (name, r)
        assert res[1]["misses"] == 0, (name, res[1])
        record(name, res, 2, blocks=tk // bk)
    serve.fresh_cim_state()

    # -- a composed integer graph, int8 and int16 --------------------------
    m, kk, n = LOWER_GRAPH_MKN
    for seed, dtype in ((0, torch.int8), (1, torch.int16)):
        info = torch.iinfo(dtype)
        a, b, c = (torch.randint(info.min, info.max + 1, (LOWER_GRAPH_WORDS,),
                                 dtype=dtype, device=dev, generator=gen)
                   for _ in range(3))
        xm = torch.randint(-128, 128, (m, kk), dtype=torch.int8, device=dev,
                           generator=gen)
        wm = torch.randint(-128, 128, (kk, n), dtype=torch.int8, device=dev,
                           generator=gen)
        fn = composed_graph(seed, dtype)
        want = fn(a, b, c, xm, wm)
        name = f"graph {str(dtype).split('.')[-1]}"
        lf = lower(fn)
        comp = lf.trace(a, b, c, xm, wm)
        res = calls(name, lambda: lf(a, b, c, xm, wm))
        for r in res:
            assert all(torch.equal(g_, w_) for g_, w_ in zip(r["y"], want)), \
                name
            assert r["accesses"] == comp.accesses > 0, (name, r)
        never = lower(fn, policy="never")
        LEDGER.reset()
        got = never(a, b, c, xm, wm)
        torch.cuda.synchronize()
        assert LEDGER.accesses == 0
        assert all(torch.equal(g_, w_) for g_, w_ in zip(got, want)), name
        record(name, res, len(comp.regions), never_equal=True)
    serve.fresh_cim_state()
    gc.collect()
    torch.cuda.empty_cache()
    return out


#: the analog phase's full-width access: the main path's largest (the last
#: tree-reduction add of gemma-2b's down projection at 2 slots)
ANALOG_FULL = (29, (2 * 16384 * 2048) // 32)
#: card-vs-CPU tolerance of the device model's currents and voltages: both
#: compute in float32, and torch's exp/log1p differ by ulps between builds;
#: every margin is above 1 uA or 50 mV
ANALOG_RTOL = 1e-5


def phase_analog(dev) -> dict:
    """The paper's FeFET device model on the card, through the analog-oracle
    backend: (a) the level currents and sense margins on the card against
    the CPU; (b) every 8-bit (x, y) pair in analog mode through cim_add,
    cim_sub, cim_compare, cim_add_sub and the 16 Boolean functions, equal
    to exact integers and to mode="boolean"; (c) the main path's largest
    access (29 planes x 2^21 columns, seeded random planes): every op of
    the catalogue alone and all in one access, the fused kernel equal to
    the bit to the device model, both timed; (d) gemma-2b's decode MLP at
    full width through `mlp_cim(backend="analog-oracle")` against the fused
    backend (output, accesses, loads, per-op charges), and one
    `execute_tiled` access on the paper's banked array; (e) `analyze` of
    that MLP on CUDA tensors against its executed ledger."""
    import torch

    from repro_torch.cim import array, backends, cost, dispatch, fused_kernel
    from repro_torch.cim import opset
    from repro_torch.cim.accounting import LEDGER
    from repro_torch.cim.planepack import PlanePack
    from repro_torch.configs import preset_config
    from repro_torch.core import adra, sensing
    from repro_torch.core.array import AdraArrayConfig, level_currents
    from repro_torch.core.offload import analyze
    from repro_torch.launch import serve
    from repro_torch.models import layers

    fused = fused_kernel.fused_planes_op
    analog = backends.get_backend("analog-oracle")
    cpu = torch.device("cpu")
    out = {}

    # (a) the device model, on the card and on the CPU
    acfg = AdraArrayConfig()
    model = {}
    for name, fn in (
            ("levels", lambda d: level_currents(acfg, True, device=d)),
            ("levels_symmetric", lambda d: level_currents(acfg, False,
                                                          device=d)),
            ("current_margins",
             lambda d: sensing.current_sense_margins(acfg, device=d)),
            ("voltage_margins",
             lambda d: sensing.voltage_sense_margins(acfg, 1e-9, device=d))):
        got, want = fn(dev), fn(cpu)
        assert got.device.type == "cuda", name
        torch.testing.assert_close(got.cpu(), want, rtol=ANALOG_RTOL, atol=0)
        model[name] = got.cpu().tolist()
    lv = model["levels"]
    assert lv[0] < lv[1] < lv[2] < lv[3], lv
    assert min(model["current_margins"]) > 1e-6, model
    assert min(model["voltage_margins"]) > 50e-3, model
    assert sensing.symmetric_sense_is_ambiguous(acfg, device=dev)
    out["device_model"] = model
    print("analog[device]: I_SL (uA) 00 {:.6g}, 10 {:.6g}, 01 {:.6g}, 11 "
          "{:.6g}; current margins (uA) {}; voltage margins at 1 ns (mV) {};"
          " symmetric levels (uA) {}: many-to-one; card within rtol {:g} of "
          "the CPU".format(
              *(v * 1e6 for v in lv),
              [f"{v * 1e6:.6g}" for v in model["current_margins"]],
              [f"{v * 1e3:.6g}" for v in model["voltage_margins"]],
              [f"{v * 1e6:.6g}" for v in model["levels_symmetric"]],
              ANALOG_RTOL))

    # (b) exhaustive 8-bit, analog mode against integers and boolean mode
    t = time.perf_counter()
    v = torch.arange(-128, 128, dtype=torch.int32, device=dev)
    x, y = (g.reshape(-1) for g in torch.meshgrid(v, v, indexing="ij"))
    pa, pb, m = x & 255, y & 255, 255
    bool_ref = {
        "false": torch.zeros_like(pa), "true": torch.full_like(pa, m),
        "and": pa & pb, "or": pa | pb, "xor": pa ^ pb,
        "nand": ~(pa & pb) & m, "nor": ~(pa | pb) & m,
        "xnor": ~(pa ^ pb) & m, "a": pa, "b": pb, "not_a": ~pa & m,
        "not_b": ~pb & m, "a_and_not_b": pa & ~pb & m,
        "not_a_and_b": ~pa & m & pb, "a_or_not_b": (pa | (~pb & m)) & m,
        "not_a_or_b": ((~pa & m) | pb) & m}
    checked = 0

    def same(got, want, what):
        nonlocal checked
        assert got.is_cuda and torch.equal(got, want), what
        checked += 1

    for mode in ("analog", "boolean"):
        ad, sb = adra.cim_add(x, y, 8, mode), adra.cim_sub(x, y, 8, mode)
        same(ad.value, x + y, (mode, "add"))
        same(sb.value, x - y, (mode, "sub"))
        c = adra.cim_compare(x, y, 8, mode)
        for got, want in zip(c, (x < y, x == y, x > y)):
            same(got, want.to(torch.int32), (mode, "compare"))
        both = adra.cim_add_sub(x, y, 8, mode)
        same(both.add, x + y, (mode, "add_sub"))
        same(both.sub, x - y, (mode, "add_sub"))
        for fn in adra.BOOLEAN_FUNCTIONS:
            same(adra.cim_boolean(x, y, fn, 8, mode), bool_ref[fn],
                 (mode, fn))
    for fn_name in ("cim_add", "cim_sub"):
        fa = getattr(adra, fn_name)(x, y, 8, "analog")
        fb = getattr(adra, fn_name)(x, y, 8, "boolean")
        for got, want in zip(fa, fb):
            same(got, want, (fn_name, "analog vs boolean"))
    torch.cuda.synchronize()
    out["exhaustive"] = {"pairs": int(x.numel()), "checks": checked,
                         "s": time.perf_counter() - t}
    print(f"analog[8-bit]: {x.numel()} pairs x (add, sub, compare, add_sub, "
          f"16 Boolean) in analog and boolean mode: {checked} checks exact "
          f"in {out['exhaustive']['s']:.2f} s")

    # (c) the largest access at full width: kernel against the device model
    n_bits, w = ANALOG_FULL
    gen = torch.Generator(device=dev).manual_seed(0)
    a, b = (torch.randint(-2 ** 31, 2 ** 31, (n_bits, w), dtype=torch.int32,
                          device=dev, generator=gen) for _ in range(2))
    t = time.perf_counter()
    requests = [(op,) for op in opset.ALL_OPS] + [opset.ALL_OPS]
    for ops in requests:
        for op, g, s in zip(ops, fused(a, b, ops), analog(a, b, ops)):
            assert torch.equal(g, s), f"kernel != device model for {op}"
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    timing = {}
    for name, ops in (("add", ("add",)), ("all", opset.ALL_OPS)):
        start.record()
        analog(a, b, ops)
        stop.record()
        torch.cuda.synchronize()
        timing[f"analog_{name}_ms"] = start.elapsed_time(stop)
        timing[f"kernel_{name}_ms"] = cuda_ms(lambda: fused(a, b, ops),
                                              reps=10)
    out["full_width"] = {"shape": [n_bits, w], "requests": len(requests),
                         "s": full_s, **timing}
    print(f"analog[full]: {len(requests)} accesses (each op alone, then all "
          f"{len(opset.ALL_OPS)} in one) at {n_bits} planes x {w} columns: "
          f"fused kernel == device model to the bit, in {full_s:.1f} s; add "
          f"pass {timing['analog_add_ms']:.1f} ms on the device model "
          f"against {timing['kernel_add_ms']:.4f} ms on the kernel; all ops "
          f"{timing['analog_all_ms']:.1f} ms against "
          f"{timing['kernel_all_ms']:.4f} ms ({smi_line()})")
    del a, b

    # (d) the lowered path: gemma-2b's decode MLP at full width, seed 0
    cfg = preset_config("gemma-2b", "full")
    gen = torch.Generator(device=dev).manual_seed(0)
    act = cfg.activation_dtype()
    p = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gating, act, dev)
    xs = torch.randn((2, 1, cfg.d_model), generator=gen, device=dev).to(act)
    runs = {}
    for bk in ("fused", "analog-oracle"):
        LEDGER.reset()
        fused.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        y_out = layers.mlp_cim(p, xs, cfg.gating, 8, backend=bk)
        torch.cuda.synchronize()
        runs[bk] = {"y": y_out, "s": time.perf_counter() - t,
                    "accesses": LEDGER.accesses,
                    "loads": LEDGER.load_accesses,
                    "per_op": dict(LEDGER.per_op),
                    "launches": fused.launches}
    rf, ra = runs["fused"], runs["analog-oracle"]
    assert torch.equal(rf["y"], ra["y"]), "analog MLP != fused MLP"
    for k in ("accesses", "loads", "per_op"):
        assert rf[k] == ra[k], (k, rf[k], ra[k])
    assert rf["launches"] == rf["accesses"] and ra["launches"] == 0
    out["launches"] = rf["launches"]
    out["mlp"] = {k: {f: r[f] for f in ("s", "accesses", "loads",
                                        "launches")}
                  for k, r in runs.items()}
    print(f"analog[mlp]: gemma-2b decode MLP (2 x {cfg.d_model}, "
          f"{cfg.gating} {cfg.d_ff}, int8) through mlp_cim: analog-oracle "
          f"== fused to the bit, {ra['accesses']} accesses and "
          f"{ra['loads']} loads each; {rf['s']:.2f} s fused "
          f"({rf['launches']} launches), {ra['s']:.1f} s on the device model")

    n_words = 1 << 26
    planes = [torch.randint(-2 ** 31, 2 ** 31, (n_bits, n_words // 32),
                            dtype=torch.int32, device=dev, generator=gen)
              for _ in range(2)]
    pa_, pb_ = (PlanePack(planes=q, n_bits=n_bits, signed=True,
                          shape=(n_words,)) for q in planes)
    ops = ("add", "lt", "xor")
    tiled = {}
    for bk in ("fused", "analog-oracle"):
        LEDGER.reset()
        res = dispatch.execute_tiled(pa_, pb_, ops, spec=array.DEFAULT_SPEC,
                                     backend=bk)
        tiled[bk] = (res, LEDGER.accesses, dict(LEDGER.bank_accesses),
                     LEDGER.activated_words32)
    for op in ops:
        assert torch.equal(tiled["fused"][0][op].planes,
                           tiled["analog-oracle"][0][op].planes), op
    assert tiled["fused"][1:] == tiled["analog-oracle"][1:]
    out["tiled"] = {"tiles": tiled["fused"][1],
                    "banks": len(tiled["fused"][2])}
    print(f"analog[tiled]: one {ops} access of {n_words} words on the "
          f"paper's array ({tiled['fused'][1]} tiles over "
          f"{len(tiled['fused'][2])} banks): analog-oracle == fused to the "
          f"bit, ledgers equal")
    del planes, pa_, pb_, tiled

    # (e) the estimator on the card's tensors equals the executed ledger
    rep = analyze(lambda q, z: layers._mlp_quantized(q, z, cfg.gating, 8),
                  p, xs, policy=cost.DEFAULT_POLICY)
    assert rep.adra_accesses == rf["accesses"], (rep.adra_accesses,
                                                  rf["accesses"])
    out["analyze"] = {"adra_accesses": rep.adra_accesses,
                      "op_histogram": rep.op_histogram,
                      "words32": rep.words32,
                      "edp_decrease_pct": rep.edp_decrease_pct}
    print(f"analog[analyze]: {rep.adra_accesses} projected accesses == "
          f"{rf['accesses']} executed; histogram {rep.op_histogram}, "
          f"words32 {rep.words32}, EDP -{rep.edp_decrease_pct:.1f}%")
    del p, xs, runs, rf, ra
    layers._LOWERED_MLP.clear()
    serve.fresh_cim_state()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def rglru_bounds(b: int, t: int, d: int, itemsize: int, h0: bool,
                 sm_mhz: float) -> dict:
    """Least time of one call, the larger of three: x, r, i read and y
    written once (plus log_lambda, h0, h_T) over 3.35 TB/s; the float
    operations over 67 TFLOP/s; the special-function operations over the
    SFU rate at the card's maximum SM clock (`sm_mhz`)."""
    moved = 4 * b * t * d * itemsize + 4 * b * d * (2 if h0 else 1) + 4 * d
    n = b * t * d
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = RGLRU_OPS_PER_ELEMENT * n / F32_OPS_PER_S * 1e3
    t_sfu = (RGLRU_SFU_PER_ELEMENT * n
             / (SFU_PER_CLOCK_SM * H100_SMS * sm_mhz * 1e6) * 1e3)
    return {"bound_ms": max(t_bytes, t_ops, t_sfu),
            "bound_by": "bytes" if t_bytes >= max(t_ops, t_sfu)
            else "operations",
            "bytes": moved, "bytes_ms": t_bytes, "ops_ms": t_ops,
            "sfu_ms": t_sfu}


def device_ms(fn, args, name: str, reps: int) -> float:
    """The device time per launch of the kernels whose name holds `name`,
    from torch.profiler over `reps` calls of fn(*args)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name in e.key]
    return (sum(e.self_device_time_total for e in rows) / 1e3
            / max(1, sum(e.count for e in rows)))


def phase_rglru(dev, sm_mhz: float) -> dict:
    """Both RG-LRU kernels against `rglru_ref` on the card, every case of
    RGLRU_CASES in float32 and bfloat16, with and without h0. float32: y
    and h_T at atol 1e-5 (the reference's own tolerance). bfloat16 inputs:
    h_T at atol 1e-5 (both compute in float32); y within one bf16 rounding
    of the plain version's y, |dy| <= 2^-7 |y| + 1e-5 (the two float32
    values, rounded to nearest even, can land on neighbouring bf16 values).
    The TMA kernel repeats the rows kernel's arithmetic, so wherever it
    takes the input their y and h_T must be equal to the bit; every routed
    call must launch the kernel `rglru.route` names, by the counts."""
    import torch

    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels.ref import rglru_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    kernels = {"sm90": rg.rglru_sm90, "rows": rg.rglru_rows}
    names = {"sm90": "rglru_tile_kernel", "rows": "rglru_kernel"}
    max_err = {"sm90": 0.0, "rows": 0.0}
    cases = 0
    routed = {"sm90": 0, "rows": 0}

    def inputs(shape, dtype, with_h0):
        b, _, d = shape
        x, r, i = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        ll = torch.randn((d,), generator=gen, device=dev)
        h0 = (torch.randn((b, d), generator=gen, device=dev)
              if with_h0 else None)
        return x, r, i, ll, h0

    def check(what, y, h, yp, hp, dtype):
        assert y.dtype == dtype and h.dtype == torch.float32, what
        h_err = float((h - hp).abs().max())
        dy = (y.float() - yp.float()).abs()
        y_err = float(dy.max())
        if dtype == torch.float32:
            ok = y_err <= 1e-5
        else:
            ok = bool((dy <= 2.0 ** -7 * yp.float().abs() + 1e-5).all())
        if h_err > 1e-5 or not ok:
            raise AssertionError(f"rglru {what} != plain: y {y_err}, h_T "
                                 f"{h_err}")
        return max(h_err, y_err)

    for shape in RGLRU_CASES:
        shape_routes = set()
        for dtype in (torch.float32, torch.bfloat16):
            for with_h0 in (False, True):
                args = inputs(shape, dtype, with_h0)
                what = f"at {shape} {str(dtype)[6:]} h0={with_h0}"
                want = rg.route(*args[:3])
                before = {k: fn.launches for k, fn in kernels.items()}
                y, h = rg.rglru(*args)
                torch.cuda.synchronize()
                moved = {k: fn.launches - before[k]
                         for k, fn in kernels.items()}
                assert moved == {k: int(k == want) for k in kernels}, \
                    (what, want, moved)
                routed[want] += 1
                shape_routes.add(want)
                yp, hp = rglru_ref(*args)
                outs = {want: (y, h)}
                other = "rows" if want == "sm90" else "sm90"
                if other == "rows" or rg.sm90_takes(*args[:3]):
                    outs[other] = kernels[other](*args)
                for k, (yk, hk) in outs.items():
                    err = check(f"{k} {what}", yk, hk, yp, hp, dtype)
                    max_err[k] = max(max_err[k], err)
                if len(outs) == 2:
                    (ya, ha), (yb, hb) = outs["sm90"], outs["rows"]
                    if not (torch.equal(ya, yb) and torch.equal(ha, hb)):
                        raise AssertionError(
                            f"rglru sm90 != rows to the bit {what}: y "
                            f"{float((ya.float() - yb.float()).abs().max())}"
                            f", h_T {float((ha - hb).abs().max())}")
                cases += 1
        print(f"rglru[{', '.join(sorted(shape_routes))}]: {shape}: within "
              f"tolerance in float32 and bf16, with and without h0"
              f"{'; sm90 == rows to the bit' if rg.sm90_takes(*args[:3]) else '; rows only (TMA cannot address D)'}")

    # the prefill and decode shapes: the TMA kernel, the rows kernel, the
    # TMA kernel again and the plain version in turns; CUDA events around
    # rounds of launches (median of 5) time a call as a caller pays it, the
    # profiler's device rows each kernel's own time per launch
    timings = {}
    for shape, with_h0 in RGLRU_TIMED:
        args = inputs(shape, torch.bfloat16, with_h0)
        slow = shape[1] > 1
        row = {"route": rg.route(*args[:3])}
        for key, k in (("sm90", "sm90"), ("rows", "rows"),
                       ("sm90_again", "sm90")):
            fn = kernels[k]
            reps = 2 if (k == "rows" and slow) else 10
            row[f"{key}_call_ms"] = sorted(
                cuda_ms(lambda: fn(*args), reps=reps) for _ in range(5))[2]
            row[f"{key}_ms"] = device_ms(fn, args, names[k], reps)
        row["plain_ms"] = sorted(cuda_ms(lambda: rglru_ref(*args),
                                         reps=2 if slow else 10)
                                 for _ in range(3))[1]
        row.update(rglru_bounds(*shape, 2, with_h0, sm_mhz))
        timings[shape] = row
        print(f"rglru: {shape} bf16 h0={with_h0} (route {row['route']}): "
              f"device ms a launch sm90 {row['sm90_ms']:.4f} (again "
              f"{row['sm90_again_ms']:.4f}), rows {row['rows_ms']:.4f}; call "
              f"median sm90 {row['sm90_call_ms']:.4f}, rows "
              f"{row['rows_call_ms']:.4f}; plain median "
              f"{row['plain_ms']:.4f}; bound {row['bound_ms']:.6f} ms "
              f"({row['bound_by']}: bytes {row['bytes_ms']:.6f}, float ops "
              f"{row['ops_ms']:.6f}, SFU {row['sfu_ms']:.6f} at {sm_mhz:g} "
              f"MHz; {row['bytes']} B)")

    # the TMA kernel's geometry: channels a block x input ring depth at the
    # default warps, then 8 to 32 warps a block at the default C and ring;
    # each launch held to the rows kernel's output to the bit
    sweep = {}
    for shape in ((1, 2048, 4096), (2, 2048, 4096)):
        args = inputs(shape, torch.bfloat16, False)
        dims = rg._check_all(*args)
        yr, hr = rg.rglru_rows(*args)
        geoms = [rg.tile_geometry(*shape, torch.bfloat16, channels=c,
                                  stages=s)
                 for c in (16, 32) for s in (2, 3, 4)]
        geoms += [rg.tile_geometry(*shape, torch.bfloat16, warps=w)
                  for w in (8, 12, 16, 20, 24, 28, 32)]
        row = []
        for geom in geoms:
            def call(*_):
                return rg._launch(rg.SOURCE_SM90, dims, *args, 8.0, geom)
            y, h = call()
            assert torch.equal(y, yr) and torch.equal(h, hr), (shape, geom)
            row.append({"channels": geom.channels, "stages": geom.stages,
                        "warps": geom.warps,
                        "blocks": geom.blocks, "smem": geom.smem,
                        "device_ms": device_ms(call, (), names["sm90"], 10)})
        sweep[str(list(shape))] = row
        default = rg.tile_geometry(*shape, torch.bfloat16)
        print(f"rglru: sm90 sweep {shape} bf16 (C / stages / warps: device "
              f"ms a launch; default C {default.channels}, {default.stages} "
              f"stages, {default.warps} warps): "
              + ", ".join(f"{r['channels']}/{r['stages']}/{r['warps']}"
                          f": {r['device_ms']:.4f}" for r in row)
              + "; each equal to the bit to the rows kernel")

    # both kernels over T, for the routing threshold: device time a launch
    # and call median (CUDA events, 5 rounds of 10)
    t_sweep = []
    for b in (1, 2):
        for t in (1, 2, 4, 8, 12, 16, 24, 32, 64, 128):
            args = inputs((b, t, 4096), torch.bfloat16, False)
            row = {"shape": [b, t, 4096], "route": rg.route(*args[:3])}
            for k, fn in kernels.items():
                row[f"{k}_ms"] = device_ms(fn, args, names[k], 10)
                row[f"{k}_call_ms"] = sorted(
                    cuda_ms(lambda: fn(*args), reps=10) for _ in range(5))[2]
            t_sweep.append(row)
        print(f"rglru: T sweep (B {b}, D 4096, bf16; T: sm90 / rows device ms"
              f" a launch, call medians): " + ", ".join(
                  f"{r['shape'][1]}: {r['sm90_ms']:.4f} / {r['rows_ms']:.4f}"
                  f" ({r['sm90_call_ms']:.4f} / {r['rows_call_ms']:.4f})"
                  for r in t_sweep if r["shape"][0] == b)
              + f"; route sends T >= {rg.SM90_MIN_T} to sm90")
    print(f"rglru: {cases} routed cases within tolerance ({routed['sm90']} "
          f"on the sm90 kernel, {routed['rows']} on the rows kernel; max abs "
          f"diff sm90 {max_err['sm90']:.3e}, rows {max_err['rows']:.3e})")
    main = timings[(1, 2048, 4096)]
    return {"max_abs_err": max(max_err.values()),
            "max_abs_err_rows": max_err["rows"], "cases": cases,
            "routed": routed, "ms": main["sm90_ms"],
            "call_ms": main["sm90_call_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "shape": [1, 2048, 4096],
            "timings": [{"shape": list(s), **timings[s]}
                        for s, _ in RGLRU_TIMED],
            "sweep": sweep, "t_sweep": t_sweep}


def slstm_bounds(b: int, t: int, d: int, wx_size: int, r_size: int) -> dict:
    """Least time of one call: wx, R, b and the initial state read once,
    y and the final state written once; 2 * 4D^2 operations per row and
    step for h R plus the gates."""
    moved = (b * t * 4 * d * wx_size + (4 * d * d + 4 * d) * r_size
             + 2 * 4 * b * d * 4 + b * t * d * wx_size)
    ops = b * t * (2 * 4 * d * d + SLSTM_GATE_OPS * d)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": moved, "ops": ops}


def phase_slstm(dev) -> dict:
    """The sLSTM kernels against `slstm_ref` on the card (TF32 off for the
    plain version's products), each case on the kernel `slstm.route` picks,
    asserted by the launch counts. R is drawn as the model draws it,
    N(0, 1/D): with the reference test's N(0, 0.04) at D >= 768 the
    recurrence is chaotic, and float32 runs that differ only in summation
    order part within a few dozen steps. Float32 outputs: atol 1e-5 up to
    T = 64 (the reference's own), 1e-4 at T = 512 and 2048, where the
    recurrence carries the different summation order of h R. The state is
    float32 always; a bfloat16 y must lie within one bf16 rounding of the
    plain version's, |dy| <= 2^-7 |y| + atol.

    The two widest shapes (D = 3000 and 7000, which take 4 and 8 channels
    per thread) are held to exact arithmetic instead: the kernel's
    difference from the plain version run in float64 may exceed the float32
    plain version's own by at most atol. At these widths float32 summation
    alone moves the state by about 1e-5 (the plain version in float32 against
    float64, seen on the CPU: up to 1.05e-5 at D = 7000), so two float32
    summation orders cannot be held within 1e-5 of each other; at D = 3000
    the kernel's sequential sum differed from the plain version's by
    1.29e-5 on c (measured on one H100)."""
    import torch

    from repro_torch.kernels import slstm as sm
    from repro_torch.kernels.ref import slstm_ref

    gen = torch.Generator(device=dev).manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16
    kernels = {"sm90": sm.slstm_sm90, "rows": sm.slstm_rows}

    def inputs(shape, wx_dtype, r_dtype, random_state):
        b, t, d = shape
        wx = torch.randn((b, t, 4, d), generator=gen, device=dev)
        r = torch.randn((d, 4, d), generator=gen, device=dev) / d ** 0.5
        bg = 0.1 * torch.randn((4, d), generator=gen, device=dev)
        if random_state:
            h0, c0, m0 = (torch.randn((b, d), generator=gen, device=dev)
                          for _ in range(3))
            n0 = 0.5 + 1.5 * torch.rand((b, d), generator=gen, device=dev)
        else:
            h0, c0, m0 = (torch.zeros((b, d), device=dev) for _ in range(3))
            n0 = torch.ones((b, d), device=dev)
        return (wx.to(wx_dtype), r.to(r_dtype), bg.to(r_dtype), h0, c0, n0,
                m0)

    max_err = 0.0
    max_bf16_dy = 0.0
    cases = 0
    routed = {"sm90": 0, "rows": 0}
    # (2,512,768) and (4,64,768): several rows share each block's slice of
    # R across many barriers; (33,8,768) and (40,1,768): xlstm-125m's width
    # with more rows than the grid takes, on the rows kernel (serve with
    # more than 32 slots); D = 1500 takes the grid with bf16 R only; the
    # last two take the rows kernel at 4 and 8 channels per thread (D =
    # 7000 needs more than 48 KB of shared memory); D > 1500 is held to
    # float64
    for shape in ((3, 32, 64), (5, 64, 128), (2, 48, 256), (2, 1, 768),
                  (1, 512, 768), (1, 2048, 768), (2, 512, 768), (4, 64, 768),
                  (33, 8, 768), (40, 1, 768), (3, 37, 1500), (2, 9, 3000),
                  (1, 5, 7000)):
        atol = 1e-5 if shape[1] <= 64 else 1e-4
        shape_err = shape_excess = 0.0
        shape_routes = set()
        for wx_dtype, r_dtype in ((f32, f32), (f32, bf16), (bf16, bf16)):
            for random_state in (False, True):
                args = inputs(shape, wx_dtype, r_dtype, random_state)
                want = sm.route(args[0], args[1])
                before = {k: fn.launches for k, fn in kernels.items()}
                y, state = sm.slstm(*args)
                yp, statep = slstm_ref(*args)
                torch.cuda.synchronize()
                moved = {k: fn.launches - before[k]
                         for k, fn in kernels.items()}
                assert moved == {k: int(k == want) for k in kernels}, \
                    (shape, wx_dtype, r_dtype, want, moved)
                routed[want] += 1
                shape_routes.add(f"{want} (R {str(r_dtype)[6:]})")
                assert y.dtype == wx_dtype
                assert all(a.dtype == f32 for a in state)
                outs, plain = list(state), list(statep)
                if wx_dtype == f32:
                    outs.append(y)
                    plain.append(yp)
                diffs = [float((a - p).abs().max())
                         for a, p in zip(outs, plain)]
                errs = diffs
                if shape[2] > 1500:      # against exact arithmetic
                    ye, exact = slstm_ref(*(a.double() for a in args))
                    exact = list(exact) + [ye]
                    errs = [max(0.0, float((a.double() - e).abs().max())
                                - float((p.double() - e).abs().max()))
                            for a, p, e in zip(outs, plain, exact)]
                    shape_excess = max(shape_excess, *errs)
                y_ok = True
                if wx_dtype == bf16:
                    dy = (y.float() - yp.float()).abs()
                    y_ok = bool((dy <= 2.0 ** -7 * yp.float().abs()
                                 + atol).all())
                    max_bf16_dy = max(max_bf16_dy, float(dy.max()))
                if max(errs) > atol or not y_ok:
                    raise AssertionError(
                        f"slstm ({want}) != plain at {shape} wx {wx_dtype} "
                        f"R {r_dtype} random_state={random_state}: h, c, n, "
                        f"m{', y' if wx_dtype == f32 else ''} errors {errs}, "
                        f"bf16 y within one rounding {y_ok}")
                shape_err = max(shape_err, *diffs)
                cases += 1
        max_err = max(max_err, shape_err)
        kinds = ", ".join(sorted(shape_routes))
        if shape[2] > 1500:
            print(f"slstm[{kinds}]: {shape}: max abs diff {shape_err:.3e}; "
                  f"farther from float64 than the float32 plain version by "
                  f"at most {shape_excess:.3e} (bound atol {atol:g})")
        else:
            print(f"slstm[{kinds}]: {shape}: max abs diff {shape_err:.3e} "
                  f"(bound atol {atol:g})")

    # a grid that cannot all be resident is refused, never started: the
    # sm90 launcher at D = 4096 with one channel a block asks for 4096
    # blocks of 49 KB (at most 4 a SM by shared memory)
    d = 4096
    bufs = [torch.zeros(shape, dtype=dtype, device=dev) for shape, dtype in (
        ((1, 1, 4, d), f32), ((d, 4, d), bf16), ((4, d), bf16))] + [
        torch.zeros((1, d), device=dev) for _ in range(9)] + [
        torch.zeros((2, 1, d), device=dev),
        torch.zeros(1, dtype=torch.int64, device=dev)]
    geom = sm.grid_geometry(1, d, bf16, blocks=d)
    assert geom.channels == 1
    with torch.cuda.device(dev):
        rc = sm._launcher(sm.SOURCE_SM90)(
            *(t.data_ptr() for t in bufs), 1, 1, d, 0, 1, *geom,
            torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert rc == 720, rc             # cudaErrorCooperativeLaunchTooLarge
    print(f"slstm: a grid of {d} blocks that cannot be co-resident: launch "
          f"refused (cudaError {rc})")
    del bufs

    # the serve path's dtypes: float32 wx and y, bfloat16 R and b. Both
    # kernels in turns (sm90, rows, sm90) on the same inputs: CUDA events
    # around a round of launches, median of the rounds; the profiler's
    # device rows give each kernel's own time per launch
    timings = {}
    for shape, random_state in (((2, 1, 768), True), ((1, 512, 768), False),
                                ((1, 2048, 768), False)):
        args = inputs(shape, f32, bf16, random_state)
        assert sm.route(args[0], args[1]) == "sm90", shape
        t = shape[1]
        slow = t > 1                       # the rows kernel: 0.1 ms a step
        rounds = sorted(cuda_ms(lambda: sm.slstm_sm90(*args), reps=10)
                        for _ in range(5))
        rows = sorted(cuda_ms(lambda: sm.slstm_rows(*args),
                              reps=2 if slow else 10)
                      for _ in range(3 if slow else 5))
        again = sorted(cuda_ms(lambda: sm.slstm_sm90(*args), reps=10)
                       for _ in range(5))
        plain = sorted(cuda_ms(lambda: slstm_ref(*args), reps=2 if slow
                               else 10) for _ in range(3 if slow else 5))
        dev_ms = device_ms(sm.slstm_sm90, args, "slstm_grid_kernel", 10)
        rows_dev = device_ms(sm.slstm_rows, args, "slstm_kernel",
                             2 if slow else 10)
        bounds = slstm_bounds(*shape, 4, 2)
        timings[shape] = dict(ms=rounds[2], ms_again=again[2],
                              device_ms=dev_ms, rows_ms=rows[len(rows) // 2],
                              rows_device_ms=rows_dev,
                              plain_ms=plain[len(plain) // 2], **bounds)
        tm = timings[shape]
        print(f"slstm: {shape} wx f32, R bf16: sm90 median {tm['ms']:.4f} ms "
              f"(rounds {rounds[0]:.4f}-{rounds[-1]:.4f}; again "
              f"{tm['ms_again']:.4f}), device {dev_ms:.4f} ms per launch "
              f"(profiler), {dev_ms / t * 1e3:.3f} us a step; rows kernel "
              f"median {tm['rows_ms']:.4f} ms, device {rows_dev:.4f} ms "
              f"({rows_dev / t * 1e3:.3f} us a step); plain median "
              f"{tm['plain_ms']:.4f} ms; bound {bounds['bound_ms']:.6f} ms "
              f"({bounds['bound_by']}, {bounds['bytes']} B, "
              f"{bounds['ops']} operations)")
    # the grid's size, the sm90 kernel's main tuning choice: the same
    # inputs on 48, 64, 96 (GRID_BLOCKS) and 128 blocks at D = 768 (16, 12,
    # 8 and 6 channels a block), 96 again last, each held to the plain
    # version at the case list's tolerance; CUDA events' median of 5 rounds
    # (host launch cost included) and the profiler's device time a launch
    sweep = {}
    for shape, random_state in (((2, 1, 768), True), ((1, 512, 768), False),
                                ((1, 2048, 768), False)):
        args = inputs(shape, f32, bf16, random_state)
        dims = sm._check_all(*args)
        yp, statep = slstm_ref(*args)
        atol = 1e-5 if shape[1] <= 64 else 1e-4
        row = []
        for blocks in (48, 64, 96, 128, 96):
            geom = sm.grid_geometry(shape[0], shape[2], bf16, blocks=blocks)

            def call(*_):
                return sm._launch(sm.SOURCE_SM90, dims, *args, geom=geom)
            y, state = call()
            err = max(float((a - p).abs().max())
                      for a, p in zip([*state, y], [*statep, yp]))
            assert err <= atol, (shape, blocks, err)
            row.append({"blocks": -(-shape[2] // geom.channels),
                        "ms": sorted(cuda_ms(call, reps=10)
                                     for _ in range(5))[2],
                        "device_ms": device_ms(call, (), "slstm_grid_kernel",
                                               10),
                        "max_abs_err": err})
        sweep[str(list(shape))] = row
        print(f"slstm: grid sweep {shape} wx f32, R bf16 (blocks: median ms "
              f"/ device ms a launch): " + ", ".join(
                  f"{r['blocks']}: {r['ms']:.4f} / {r['device_ms']:.4f}"
                  for r in row)
              + f"; all within atol {atol:g} of the plain version")
    print(f"slstm: {cases} cases within tolerance ({routed['sm90']} on the "
          f"sm90 kernel, {routed['rows']} on the rows kernel; max abs diff "
          f"{max_err:.3e} on float32 outputs; bf16 y max diff "
          f"{max_bf16_dy:.3e})")
    keys = ("ms", "ms_again", "device_ms", "rows_ms", "rows_device_ms",
            "plain_ms", "bound_ms", "bound_by")
    dec = timings[(2, 1, 768)]
    return {"max_abs_err": max_err, **{k: dec[k] for k in keys},
            "shape": [2, 1, 768], "cases": cases, "routed": routed,
            "grid_sweep_ms": sweep,
            "long": [{"shape": list(shape), **{k: timings[shape][k]
                                               for k in keys}}
                     for shape in ((1, 512, 768), (1, 2048, 768))]}


def flash_bounds(b: int, tq: int, tk: int, hq: int, d: int, itemsize: int,
                 causal: bool, hkv: int = 1) -> dict:
    """Least time of one call: q, k, v read once (`hkv` kv heads), o and
    lse written once;
    4 D operations (QK^T and PV multiply-adds) per visible (query, key)
    pair. Float32 inputs at the float32 rate outside the tensor cores (TF32
    would not compute the same function); bfloat16 inputs at the bf16
    tensor-core rate, whose products are exact and sums float32."""
    hkv_bytes = 2 * b * tk * hkv * d * itemsize    # k and v
    moved = 2 * b * tq * hq * d * itemsize + hkv_bytes + 4 * b * hq * tq
    shift = tk - tq
    pairs = sum(min(tk, max(0, r + shift + 1)) for r in range(tq)) \
        if causal else tq * tk
    ops = 4 * d * b * hq * pairs
    rate = F32_OPS_PER_S if itemsize == 4 else BF16_TC_OPS_PER_S
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": moved, "ops": ops}


def phase_flash(dev) -> dict:
    """Flash attention against `mha_ref` (TF32 off), o and lse, as the
    reference test compares: |got - want| <= tol + tol |want|. tol is the
    reference's own (tests/test_kernels.py:113) on its four shapes: 2e-6
    in float32, 2e-2 in bfloat16. On the wider shapes (D up to 256, up to
    2048 keys) the float32 bound is 1e-5, stated before the first run: both
    sides sum D = 256 products and up to 2048 weights in float32 in
    different orders; the printed float64 distances show which side is
    farther from exact. bfloat16 inputs keep 2e-2 on o, and o's relative
    L2 distance from the plain version must stay within FLASH_BF16_REL_L2;
    lse is float32 in both dtypes and keeps the float32 bound. Every routed
    call must launch
    the kernel the routing rule names (bf16: the wgmma/TMA kernel; float32:
    SIMT), by the launch counts; the SIMT kernel is also held in bf16."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fm
    from repro_torch.kernels.ref import mha_ref

    gen = torch.Generator(device=dev).manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16
    max_err = {f32: 0.0, bf16: 0.0, "simt_bf16": 0.0}
    max_rel = {bf16: 0.0, "simt_bf16": 0.0}
    cases = 0
    for shape in FLASH_REF_SHAPES + FLASH_WIDE_SHAPES:
        b, tq, tk, hq, hkv, d = shape
        f32_tol = 2e-6 if shape in FLASH_REF_SHAPES else 1e-5
        for dtype in (f32, bf16):
            q = torch.randn((b, tq, hq, d), generator=gen, device=dev)
            k, v = (torch.randn((b, tk, hkv, d), generator=gen, device=dev)
                    for _ in range(2))
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            kernel = "sm90" if dtype == bf16 else "simt"
            assert fm.route(q, k, v) == kernel, (shape, dtype)
            runs = [("flash_attention", fm.flash_attention, kernel)]
            if dtype == bf16:
                runs.append(("simt", fm.flash_attention_simt, "simt"))
            for causal in (True, False):
                op, lsep = mha_ref(q, k, v, causal=causal)
                exact = None
                if shape in FLASH_WIDE_SHAPES:
                    exact = mha_ref(q.double(), k.double(), v.double(),
                                    causal=causal)
                for name, fn, want in runs:
                    before = (fm.flash_attention_sm90.launches,
                              fm.flash_attention_simt.launches)
                    o, lse = fn(q, k, v, causal=causal)
                    torch.cuda.synchronize()
                    moved = (fm.flash_attention_sm90.launches - before[0],
                             fm.flash_attention_simt.launches - before[1])
                    assert moved == ((1, 0) if want == "sm90" else (0, 1)), \
                        (shape, dtype, name, moved)
                    assert o.dtype == dtype and o.shape == q.shape
                    assert lse.dtype == f32 and lse.shape == (b, hq, tq)
                    o_tol = f32_tol if dtype == f32 else 2e-2
                    errs, failed = [], []
                    for what, got, ref, tol in (("o", o, op, o_tol),
                                                ("lse", lse, lsep, f32_tol)):
                        diff = (got.float() - ref.float()).abs()
                        errs.append(float(diff.max()))
                        if not bool((diff <= tol + tol * ref.float().abs())
                                    .all()):
                            failed.append(f"{what} elementwise (tol {tol})")
                    key = dtype if name == "flash_attention" else "simt_bf16"
                    rel = ""
                    if dtype == bf16:
                        r = float((o.float() - op.float()).norm()
                                  / op.float().norm())
                        max_rel[key] = max(max_rel[key], r)
                        rel = f", o rel L2 {r:.2e}"
                        if not r <= FLASH_BF16_REL_L2:
                            failed.append(f"o relative L2 (tol "
                                          f"{FLASH_BF16_REL_L2:g})")
                    if failed:
                        raise AssertionError(
                            f"flash ({want}) != mha_ref at {shape} {dtype} "
                            f"causal={causal}: o {errs[0]}, lse {errs[1]}"
                            f"{rel}; failed: {', '.join(failed)}")
                    max_err[key] = max(max_err[key], *errs)
                    note = ""
                    if exact is not None:
                        oe, lsee = exact
                        note = (f"; from float64: kernel o "
                                f"{float((o.double() - oe).abs().max()):.2e} lse "
                                f"{float((lse.double() - lsee).abs().max()):.2e},"
                                f" plain o {float((op.double() - oe).abs().max()):.2e}"
                                f" lse {float((lsep.double() - lsee).abs().max()):.2e}")
                    print(f"flash[{want}]: {shape} {str(dtype)[6:]} causal="
                          f"{causal}: o {errs[0]:.2e}, lse {errs[1]:.2e} (tol "
                          f"{o_tol:g} / {f32_tol:g}){rel}{note}")
                    cases += 1

    # the train path's shape: one microbatch of gemma-2b, causal
    b, tq, tk, hq, hkv, d = FLASH_TRAIN_SHAPE
    timings = {}
    for dtype in (bf16, f32):
        q = torch.randn((b, tq, hq, d), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((b, tk, hkv, d), generator=gen,
                            device=dev).to(dtype) for _ in range(2))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # [B, H, T, D]

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        lib_o = library().transpose(1, 2)
        o, _ = fm.flash_attention(q, k, v, causal=True)
        lib_err = float((lib_o.float() - o.float()).abs().max())
        rounds = sorted(cuda_ms(lambda: fm.flash_attention(q, k, v), reps=10)
                        for _ in range(5))
        plain = sorted(cuda_ms(lambda: mha_ref(q, k, v), reps=3)
                       for _ in range(3))
        lib = sorted(cuda_ms(library, reps=10) for _ in range(5))
        bounds = flash_bounds(b, tq, tk, hq, d, q.element_size(), True)
        key = str(dtype)[6:]
        timings[key] = dict(ms=rounds[2], plain_ms=plain[1],
                            library_ms=lib[2], **bounds)
        extra = ""
        if dtype == bf16:
            # the SIMT kernel, in turns with the routed call above (rounds
            # of 10 launches, medians of 5)
            timings[key]["simt_ms"] = sorted(
                cuda_ms(lambda: fm.flash_attention_simt(q, k, v), reps=10)
                for _ in range(5))[2]
            again = sorted(cuda_ms(lambda: fm.flash_attention(q, k, v),
                                   reps=10) for _ in range(5))
            timings[key]["ms_again"] = again[2]
            extra = (f"; SIMT kernel in bf16 {timings[key]['simt_ms']:.4f} ms,"
                     f" routed again {again[2]:.4f} ms")
        print(f"flash: train shape {FLASH_TRAIN_SHAPE} {key} causal: median "
              f"{rounds[2]:.4f} ms (rounds {rounds[0]:.4f}-{rounds[-1]:.4f}),"
              f" plain median {plain[1]:.4f} ms, library (SDPA) median "
              f"{lib[2]:.4f} ms (its o {lib_err:.2e} from the kernel's), "
              f"bound {bounds['bound_ms']:.6f} ms ({bounds['bound_by']}, "
              f"{bounds['bytes']} B, {bounds['ops']} operations){extra}")
    # llama3.2-1b's train shape (the configs phase), bf16 causal: the
    # routed kernel, the plain version and SDPA on the same inputs
    b, tq, tk, hq, hkv, d = FLASH_LLAMA_TRAIN_SHAPE
    q = torch.randn((b, tq, hq, d), generator=gen, device=dev).to(bf16)
    k, v = (torch.randn((b, tk, hkv, d), generator=gen, device=dev).to(bf16)
            for _ in range(2))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rounds = sorted(cuda_ms(lambda: fm.flash_attention(q, k, v), reps=10)
                    for _ in range(5))
    plain = sorted(cuda_ms(lambda: mha_ref(q, k, v), reps=3)
                   for _ in range(3))
    lib = sorted(cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps=10)
        for _ in range(5))
    bounds = flash_bounds(b, tq, tk, hq, d, q.element_size(), True, hkv)
    llama = dict(ms=rounds[2], plain_ms=plain[1], library_ms=lib[2],
                 bound_ms=bounds["bound_ms"], bound_by=bounds["bound_by"],
                 shape=list(FLASH_LLAMA_TRAIN_SHAPE))
    print(f"flash: llama train shape {FLASH_LLAMA_TRAIN_SHAPE} bfloat16 "
          f"causal: median {rounds[2]:.4f} ms (rounds {rounds[0]:.4f}-"
          f"{rounds[-1]:.4f}), plain median {plain[1]:.4f} ms, library "
          f"(SDPA) median {lib[2]:.4f} ms, bound {bounds['bound_ms']:.6f} ms "
          f"({bounds['bound_by']}, {bounds['bytes']} B, {bounds['ops']} "
          f"operations)")
    print(f"flash: {cases} cases within tolerance (max abs diff float32 "
          f"{max_err[f32]:.3e}, bfloat16 {max_err[bf16]:.3e}, SIMT kernel in "
          f"bfloat16 {max_err['simt_bf16']:.3e}; bfloat16 o relative L2 at "
          f"most {max_rel[bf16]:.3e}, SIMT kernel "
          f"{max_rel['simt_bf16']:.3e})")
    main = timings["bfloat16"]
    return {"max_abs_err": max_err[bf16], "max_abs_err_simt_f32": max_err[f32],
            "max_abs_err_simt_bf16": max_err["simt_bf16"],
            "o_rel_l2": max_rel[bf16], "o_rel_l2_simt": max_rel["simt_bf16"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "library_ms": main["library_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "shape": list(FLASH_TRAIN_SHAPE),
            "simt_bf16_ms": main["simt_ms"], "ms_again": main["ms_again"],
            "cases": cases, "llama_train": llama, "float32": {
                k: timings["float32"][k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}


def reset_launches() -> None:
    """Every kernel wrapper's launch count set to 0."""
    from repro_torch.cim import fused_kernel
    from repro_torch.kernels import flash_attention as fm
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import slstm as sm
    fused_kernel.fused_planes_op.launches = 0
    for w in (rg.rglru_sm90, rg.rglru_rows, sm.slstm_sm90, sm.slstm_rows,
              fm.flash_attention_sm90, fm.flash_attention_simt):
        w.launches = 0


def read_launches() -> dict:
    """Every kernel wrapper's launch count, by kernel."""
    from repro_torch.cim import fused_kernel
    from repro_torch.kernels import flash_attention as fm
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import slstm as sm
    return {"fused": fused_kernel.fused_planes_op.launches,
            "rglru_sm90": rg.rglru_sm90.launches,
            "rglru_rows": rg.rglru_rows.launches,
            "slstm_sm90": sm.slstm_sm90.launches,
            "slstm_rows": sm.slstm_rows.launches,
            "flash_sm90": fm.flash_attention_sm90.launches,
            "flash_simt": fm.flash_attention_simt.launches}


#: the float serve's step programs, each captured and replayed on the card
STEP_PROGRAMS = ("prefill", "decode", "insert")


def float_serve_eager(label: str, argv, model, rep: dict,
                      launches: dict) -> dict:
    """A float serve run `rep` (graphs on) against the same run under
    `dispatch.eager_programs()` on the same model: every step program
    captured once or more and replayed, tokens equal, every kernel's
    launches equal (`launches`: the graphed run's, counted from 0; the
    eager run's are counted from 0 too, and left for the caller to reset).
    Prints the step graphs, the capture steps left out of the window and
    both runs' p50 and tok/s. Returns the graph report's summary."""
    from repro_torch.cim import dispatch
    from repro_torch.launch import serve

    graphs = rep["step_graphs"]
    for name in STEP_PROGRAMS:
        g = graphs[name]
        assert g["captured"] > 0 and g["replays"] > 0, (label, name, g)
    reset_launches()
    with dispatch.eager_programs():
        eager = serve.main(argv, model=model)
    got = [r["token_ids"] for r in rep["per_request"]]
    want = [r["token_ids"] for r in eager["per_request"]]
    assert got == want, (label, got, want)
    assert read_launches() == launches, (label, read_launches(), launches)
    assert eager["graphs"]["captured"] == eager["graphs"]["replays"] == 0
    kinds = [r["prefill_kind"] for r in rep["per_request"]]
    print(f"{label}: step graphs " + ", ".join(
        f"{k} {graphs[k]['captured']} captured / {graphs[k]['replays']} "
        f"replays / {graphs[k]['capture_s']:.3f} s" for k in STEP_PROGRAMS)
        + f"; capture steps {rep['capture_steps']} "
        f"({[round(x, 2) for x in rep['capture_step_ms']]} ms) left out of "
        f"the window; prefills {kinds}, replayed prefill mean "
        f"{rep['prefill_ms_replay_mean']} ms; graphs: p50 "
        f"{rep['p50_ms']:.3f} ms, {rep['tok_s_steady']:.4f} tok/s; eager "
        f"programs: p50 {eager['p50_ms']:.3f} ms, "
        f"{eager['tok_s_steady']:.4f} tok/s; tokens and launches equal")
    return {"step_graphs": graphs, "capture_steps": rep["capture_steps"],
            "capture_step_ms": rep["capture_step_ms"],
            "prefill_kinds": kinds,
            "prefill_ms_replay_mean": rep["prefill_ms_replay_mean"],
            "p50_ms": rep["p50_ms"], "tok_s_steady": rep["tok_s_steady"],
            "eager_p50_ms": eager["p50_ms"],
            "eager_tok_s_steady": eager["tok_s_steady"]}


def train_eager(label: str, argv, build_model, rep: dict, launches: dict,
                dev) -> dict:
    """A train run `rep` (the step captured as one CUDA graph) against the
    same steps under `dispatch.eager_programs()` from a model rebuilt by
    `build_model()` (the same seed, so the same weights; the first run's
    state freed first): the step program captured and replayed, losses,
    grad norms and learning rates equal to the bit, every kernel's
    launches equal. Prints both runs' step ms and the capture steps."""
    from repro_torch.cim import dispatch
    from repro_torch.launch import train

    g = rep["graphs"]
    assert g["captured"] == 1 and g["replays"] > 0, (label, g)
    held = _free(dev)
    assert held < 2 ** 30, f"{held} bytes still allocated before {label}"
    reset_launches()
    with dispatch.eager_programs():
        eager = train.main(argv, model=build_model())
    for k in ("loss", "grad_norm", "lr"):
        got = [r[k] for r in rep["records"]]
        want = [r[k] for r in eager["records"]]
        assert got == want, (label, k, got, want)
    assert read_launches() == launches, (label, read_launches(), launches)
    out = {"graphs": g, "capture_steps": rep["capture_steps"],
           "step_ms": [r["ms"] for r in rep["records"]],
           "eager_step_ms": [r["ms"] for r in eager["records"]],
           "tok_s_steady": rep["tok_s_steady"],
           "eager_tok_s_steady": eager["tok_s_steady"],
           "peak_gib": rep["peak_gib"], "eager_peak_gib": eager["peak_gib"]}
    print(f"{label}: step graph {g['captured']} captured / {g['replays']} "
          f"replays / {g['capture_s']:.3f} s; capture steps "
          f"{rep['capture_steps']} left out; step ms "
          f"{[round(x, 2) for x in out['step_ms']]} against eager "
          f"{[round(x, 2) for x in out['eager_step_ms']]}; steady "
          f"{rep['tok_s_steady']:.2f} tokens/s against eager "
          f"{eager['tok_s_steady']:.2f}; peak {rep['peak_gib']:.2f} GiB "
          f"against eager {eager['peak_gib']:.2f}; losses, grad norms, lrs "
          f"and launches equal to the bit")
    del eager
    _free(dev)
    return out


def rglru_expected(model, slots: int, prompt_len: int, prefills: int,
                   decode_steps: int) -> dict:
    """The RG-LRU launches a serve run makes on each kernel: one per rec
    layer for every prefill ([1, prompt, D]) and every decode step ([slots,
    1, D]), each on the kernel `rglru.route` names for that shape."""
    import torch
    from repro_torch.kernels import rglru as rg
    n_rec = model.kinds.count("rec")
    d, dtype = model.cfg.d_model, model.cfg.activation_dtype()
    want = {"sm90": 0, "rows": 0}
    for shape, calls in (((1, prompt_len, d), prefills),
                         ((slots, 1, d), decode_steps)):
        x = torch.empty(shape, dtype=dtype, device="meta")
        want[rg.route(x)] += n_rec * calls
    return want


def phase_serve(arch: str, dev, profile: bool, spec=None) -> dict:
    """One model at full width through `serve.main`: repack, resident and
    warm phases with their counts asserted (`spec`, by default PATHS'),
    then the host twin's tokens. The model is built as the serve entry
    point builds it (cast layer weights in bf16 only). Returns the model
    too, for the float prefill phase."""
    import torch
    from repro_torch.cim import fused_kernel
    from repro_torch.configs import preset_config
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import slstm as sm
    from repro_torch.launch import serve
    from repro_torch.models.model import build, with_cim

    spec = spec or PATHS[arch]
    argv = ["--arch", arch] + SERVE + spec["args"]
    args = serve.parse_args(argv)
    times = {}
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    model = build(with_cim(preset_config(arch, args.preset), args.cim_bits),
                  device=dev, seed=args.seed, for_serving=True)
    torch.cuda.synchronize()
    times["init_s"] = time.perf_counter() - t

    t = time.perf_counter()
    fused_kernel.fused_planes_op.launches = 0
    rg.rglru_sm90.launches = rg.rglru_rows.launches = 0
    sm.slstm_sm90.launches = sm.slstm_rows.launches = 0
    out = serve.main(argv, model=model)
    fused_launches = fused_kernel.fused_planes_op.launches
    rglru_launches = {"sm90": rg.rglru_sm90.launches,
                      "rows": rg.rglru_rows.launches}
    assert sm.launches() == 0, (arch, sm.launches())
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
    rglru_want = rglru_expected(
        model, args.slots, args.prompt_len,
        sum(rep["requests"] for rep in reps.values()),
        sum(rep["decode_steps"] for rep in reps.values()))
    assert rglru_launches == rglru_want, (arch, rglru_launches, rglru_want)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    for name, rep in reps.items():
        gs = rep["graphs"]
        print(f"{arch}[{name}]: {rep['tok_s_steady']:.4f} tok/s steady, "
              f"p50 {rep['p50_ms']:.2f} ms, p99 {rep['p99_ms']:.2f} ms, "
              f"prefill {rep['prefill_ms_mean']:.1f} ms mean, "
              f"{rep['decode_steps']} decode steps, "
              f"{rep['total_accesses_per_token']} total accesses/token, "
              f"wall {rep['wall_s']:.2f} s; graphs {gs['captured']} "
              f"captured, {gs['replays']} replays, "
              f"{gs['capture_s']:.3f} s capturing, {gs['eager']} eager "
              f"first calls; capture steps {rep['capture_steps']} left out "
              f"of the window")
    # the resident phase's window holds no capture step (C1): its p50
    # beside the warm phase's, where nothing is left to capture
    print(f"{arch}: p50 resident {reps['resident']['p50_ms']:.2f} ms "
          f"(capture steps {reps['resident']['capture_steps']}) beside warm "
          f"{reps['warm']['p50_ms']:.2f} ms (capture steps "
          f"{reps['warm']['capture_steps']}); tok/s resident "
          f"{reps['resident']['tok_s_steady']:.4f}, warm "
          f"{reps['warm']['tok_s_steady']:.4f}")
    print(f"{arch}: {spec['step_accesses']} accesses and "
          f"{spec['step_dispatches']} dispatches every decode step; "
          f"{fused_launches} fused launches for {charged} ledger accesses; "
          f"rglru launches {rglru_launches} (sm90 / rows, each where "
          f"rglru.route names it); peak memory {peak_gib:.2f} GiB")

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
        m = model.derive(
            dataclasses.replace(model.cfg, cim_resident=True),
            resident_spec=serve.resident_array_spec(
                model.cfg, 2, args.prompt_len + args.gen))
        serve.fresh_cim_state()
        phase_profile(m, dev, args.prompt_len + args.gen, args.prompt_len)
        times["profile_s"] = time.perf_counter() - t
    serve.fresh_cim_state()
    return {"model": model, "fused_launches": fused_launches,
            "rglru_launches": rglru_launches, "peak_gib": peak_gib,
            "graphs": {name: rep["graphs"] for name, rep in reps.items()},
            "p50_ms": {name: rep["p50_ms"] for name, rep in reps.items()},
            "capture_steps": {name: rep["capture_steps"]
                              for name, rep in reps.items()},
            "times": times}


def phase_graph_step(model, dev) -> dict:
    """One warm resident gemma-2b decode step at full width (2 slots,
    prompt 8 + gen 8) replayed from CUDA graphs against the same step's
    eager body (`dispatch.eager_programs`, the counterpart of
    `jax.disable_jit`): logits and greedy tokens equal to the bit, the
    ledger field for field, the accesses (2214), dispatches (90), fused
    launches and kernel bytes equal. Steps 1 and 2 run eagerly and pin,
    then capture (a later layer's call of a program already captures in
    step 1); each step starts from fresh caches."""
    import torch

    from repro_torch.cim import accounting, dispatch, fused_kernel
    from repro_torch.launch import serve

    spec = PATHS["gemma-2b"]
    args = serve.parse_args(["--arch", "gemma-2b"] + SERVE + spec["args"])
    max_len = args.prompt_len + args.gen
    m = model.derive(dataclasses.replace(model.cfg, cim_resident=True),
                     resident_spec=serve.resident_array_spec(
                         model.cfg, 2, max_len))
    serve.fresh_cim_state()
    step_in = {"tokens": torch.tensor([[1], [2]], device=dev),
               "positions": torch.tensor([args.prompt_len] * 2,
                                         dtype=torch.int32, device=dev)}
    fused = fused_kernel.fused_planes_op
    led = accounting.ledger()

    def step():
        caches = m.init_caches(2, max_len)
        torch.cuda.synchronize()
        led.reset()
        c0 = (fused.launches, fused.bytes,
              dispatch.cache_stats()["dispatches"])
        t = time.perf_counter()
        _, logits = m.decode_step(caches, step_in)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        counts = tuple(b - a for a, b in zip(c0, (
            fused.launches, fused.bytes,
            dispatch.cache_stats()["dispatches"])))
        return logits, dataclasses.asdict(led), counts, ms

    g0 = dispatch.graph_stats()
    step()                                   # eager: pins, records
    step()                                   # captures the rest
    capture = dispatch.graph_stats()
    graphed = step()                         # replays
    with dispatch.eager_programs():
        eager = step()
    replay = dispatch.graph_stats()
    assert torch.equal(graphed[0], eager[0]), "graph step logits differ"
    assert torch.equal(graphed[0].argmax(-1), eager[0].argmax(-1))
    assert graphed[1] == eager[1], "graph step ledger differs"
    assert graphed[2] == eager[2], (graphed[2], eager[2])
    assert graphed[1]["accesses"] == spec["step_accesses"]
    assert graphed[2][2] == spec["step_dispatches"]
    assert graphed[2][0] >= spec["step_accesses"]
    assert replay["replays"] - capture["replays"] == spec["step_dispatches"]
    out = {"graph_ms": graphed[3], "eager_ms": eager[3],
           "launches": graphed[2][0], "kernel_bytes": graphed[2][1],
           "captured": capture["captured"] - g0["captured"],
           "capture_s": capture["capture_s"] - g0["capture_s"]}
    print(f"graph step[gemma-2b]: replayed step {out['graph_ms']:.2f} ms "
          f"against the eager body's {out['eager_ms']:.2f} ms; logits, "
          f"ledger, {spec['step_accesses']} accesses, "
          f"{spec['step_dispatches']} dispatches and {out['launches']} fused "
          f"launches equal; {out['captured']} graphs captured in "
          f"{out['capture_s']:.3f} s")
    serve.fresh_cim_state()
    return out


#: the ADRA phase: the paper's comparison at 2^24 int16 words; gemma-2b's
#: serve with the ADRA sampler, then the chaos serve: ECC-protected pins
#: under seed 0 and a resident BER of 1e-9 (about 0.54 flips a pin and
#: get: 54 decode pins of 2^29 bits give about 29 single flips a step),
#: scrubbed every 2 decode steps; then a bank killed at decode step 2
ADRA_WORDS = 1 << 24
ADRA_SERVE = ["--arch", "gemma-2b", "--preset", "full", "--device", "cuda",
              "--slots", "2", "--requests", "2", "--prompt-len", "8",
              "--gen", "4", "--cim-lower", "--cim-resident", "--sampler",
              "adra", "--scrub-every", "2"]
CHAOS_ENV = {"REPRO_CIM_FAULT_SEED": "0",
             "REPRO_CIM_FAULT_RESIDENT_BER": "1e-9"}
KILL_BANK_AT = (2, 1)


def phase_adra_faults(model, dev) -> dict:
    """(a) `adra_sub` in one fused launch against `baseline_sub_then_cmp`'s
    two over 2^24 int16 words, both equal to `adra_int_ref` and to the
    torch-boolean backend, with each one's device ms and kernel bytes, and
    the `adra_bitplane_op` shims (select 0/1) against `adra_bitplane_ref`;
    (b) gemma-2b at full width through `serve.main --sampler adra`
    (repack, resident): every sampled batch's tokens equal to
    `adra_sample_ref` on the same logits, every decode step 2214 + 18
    accesses and 90 + 18 dispatches; (c) the chaos serve (ECC pins, the
    CHAOS_ENV campaign, fail-stop, scrub every 2 steps): tokens equal to
    (b)'s resident run, 0 uncorrected, corrected > 0, the ECC verify's ms
    per decode step and the peak memory; then a failover at KILL_BANK_AT
    on the serve's widened array (4 banks): tokens equal again."""
    import math

    import torch
    from repro_torch.cim import array, faults, fused_kernel
    from repro_torch.cim.planepack import PlanePack
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.adra_bitplane import (
        adra_bitplane_op, baseline_bitplane_sub_then_cmp)
    from repro_torch.launch import serve
    from repro_torch.train import step as train_step

    fused = fused_kernel.fused_planes_op
    out = {"launches": 0}
    gen = torch.Generator(device=dev).manual_seed(20)

    # (a) the paper's comparison: one access against two
    a = torch.randint(-2 ** 15, 2 ** 15, (ADRA_WORDS,), generator=gen,
                      device=dev, dtype=torch.int32)
    b = torch.randint(-2 ** 15, 2 ** 15, (ADRA_WORDS,), generator=gen,
                      device=dev, dtype=torch.int32)
    want = ref.adra_int_ref(a, b, 1, 16)
    plain = ops.adra_sub(a, b, n_bits=16, backend="torch-boolean")
    runs = {}
    for name, fn in (("adra_sub", ops.adra_sub),
                     ("baseline_sub_then_cmp", ops.baseline_sub_then_cmp)):
        fused.launches, b0 = 0, fused.bytes
        got = fn(a, b, n_bits=16)
        torch.cuda.synchronize()
        runs[name] = {"launches": fused.launches, "bytes": fused.bytes - b0}
        out["launches"] += fused.launches
        for g, w, pl in zip(got, want, plain):
            assert torch.equal(g, w) and torch.equal(g, pl), name
        runs[name]["call_ms"] = cuda_ms(lambda: fn(a, b, n_bits=16), reps=5)
    assert runs["adra_sub"]["launches"] == 1, runs
    assert runs["baseline_sub_then_cmp"]["launches"] == 2, runs
    pa, pb = PlanePack.pack(a, 16).planes, PlanePack.pack(b, 16).planes
    one = ("sub", "lt", "eq")
    for name, passes in (("adra_sub", (one,)),
                         ("baseline_sub_then_cmp", (("sub",), ("lt", "eq")))):
        rounds = sorted(cuda_ms(lambda: [fused(pa, pb, p) for p in passes],
                                reps=10) for _ in range(5))
        runs[name]["kernel_ms"] = rounds[2]
        runs[name]["kernel_ms_rounds"] = [rounds[0], rounds[-1]]
        runs[name]["plain_ms"] = cuda_ms(
            lambda: [fused_kernel.fused_planes_op_ref(pa, pb, p)
                     for p in passes], reps=3)
        runs[name]["bound"] = {k: sum(kernel_bounds(16, pa.shape[1], p)[k]
                                      for p in passes)
                               for k in ("bound_ms", "bytes")}
    for select in (0, 1):
        for g, w in zip(adra_bitplane_op(pa, pb, select),
                        ref.adra_bitplane_ref(pa, pb, select)):
            assert torch.equal(g, w), select
    for g, w in zip(baseline_bitplane_sub_then_cmp(pa, pb),
                    ref.adra_bitplane_ref(pa, pb, 1)[:1]
                    + fused_kernel.fused_planes_op_ref(pa, pb, ("lt", "eq"))):
        assert torch.equal(g, w)
    out["paper"] = runs
    for name, r in runs.items():
        print(f"adra[{name}]: {ADRA_WORDS} int16 words, {r['launches']} "
              f"launch(es), {r['bytes']} kernel B; kernel {r['kernel_ms']:.4f}"
              f" ms (rounds {r['kernel_ms_rounds'][0]:.4f}-"
              f"{r['kernel_ms_rounds'][1]:.4f}), bound "
              f"{r['bound']['bound_ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms; whole call {r['call_ms']:.4f} ms; equal to adra_int_ref "
              f"and torch-boolean")
    print("adra: adra_bitplane_op select 0/1 and the two-pass shim equal to "
          "adra_bitplane_ref")

    # (b) gemma-2b with the ADRA sampler: every sampled batch recorded
    sampled = []
    real = serve.adra_sample

    def recording(logits, n_bits=8):
        toks = real(logits, n_bits)
        sampled.append((logits.detach().clone(), toks.clone()))
        return toks
    args = serve.parse_args(ADRA_SERVE)
    levels = math.ceil(math.log2(model.cfg.vocab_padded))
    step_acc = PATHS["gemma-2b"]["step_accesses"] + levels
    step_disp = PATHS["gemma-2b"]["step_dispatches"] + levels
    t = time.perf_counter()
    serve.adra_sample = recording
    try:
        fused.launches = 0
        rep = serve.main(ADRA_SERVE, model=model)
        out["launches"] += fused.launches
    finally:
        serve.adra_sample = real
    out["sampler_s"] = time.perf_counter() - t
    for name in ("repack", "resident"):
        ph = rep["phases"][name]
        assert set(ph["step_accesses"]) == {step_acc}, (name, ph)
        assert set(ph["step_dispatches"]) == {step_disp}, (name, ph)
    n_batches = sum(2 + ph["decode_steps"] for ph in rep["phases"].values())
    assert len(sampled) == n_batches, (len(sampled), n_batches)
    for logits, toks in sampled:
        assert torch.equal(toks, train_step.adra_sample_ref(logits))
    resident = rep["phases"]["resident"]
    out["sampler"] = {"levels": levels, "step_accesses": step_acc,
                      "step_dispatches": step_disp,
                      "batches_checked": len(sampled),
                      "tok_s_resident": resident["tok_s_steady"],
                      "tokens": [r["token_ids"]
                                 for r in resident["per_request"]]}
    print(f"adra sampler: gemma-2b {step_acc} accesses and {step_disp} "
          f"dispatches every decode step (greedy's + {levels} levels); "
          f"{len(sampled)} sampled batches equal to adra_sample_ref; "
          f"resident {resident['tok_s_steady']:.4f} tok/s; tokens "
          f"{out['sampler']['tokens']}")
    del sampled

    # (c) the chaos serve, its ECC verify timed by CUDA events
    model_resident = model.derive(dataclasses.replace(model.cfg,
                                                      cim_resident=True))
    marks = []
    verify = array.ResidentSet._verify

    def timed_verify(self, entry, decay_s=0.0):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        try:
            return verify(self, entry, decay_s)
        finally:
            e1.record()
            marks.append((e0, e1))
    os.environ.update(CHAOS_ENV)
    array.ResidentSet._verify = timed_verify
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    try:
        fused.launches = 0
        chaos = serve.chaos_phase(model_resident, args, resident)
        out["launches"] += fused.launches
    finally:
        array.ResidentSet._verify = verify
        for k in CHAOS_ENV:
            os.environ.pop(k, None)
    torch.cuda.synchronize()
    out["chaos_s"] = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    f = chaos["faults"]
    assert [r["token_ids"] for r in chaos["per_request"]] == \
        out["sampler"]["tokens"]
    assert f["uncorrected"] == 0 and f["corrected"] > 0, f
    assert set(chaos["step_accesses"]) == {step_acc}, chaos["step_accesses"]
    verify_ms = sum(e0.elapsed_time(e1) for e0, e1 in marks)
    out["chaos"] = {k: f[k] for k in ("injected", "corrected", "uncorrected",
                                      "verifies", "repairs", "scrub",
                                      "ecc_verifies")}
    out["chaos"].update(
        resident_ber=float(CHAOS_ENV["REPRO_CIM_FAULT_RESIDENT_BER"]),
        seed=int(CHAOS_ENV["REPRO_CIM_FAULT_SEED"]),
        decode_steps=chaos["decode_steps"], verify_calls=len(marks),
        verify_ms=verify_ms,
        verify_ms_per_step=verify_ms / max(1, chaos["decode_steps"]),
        tok_s=chaos["tok_s_steady"], peak_gib=peak)
    c = out["chaos"]
    print(f"chaos: seed {c['seed']}, resident BER {c['resident_ber']:g}, "
          f"scrub every {args.scrub_every}: tokens equal to the fault-free "
          f"run; {c['injected']} bits injected / {c['corrected']} corrected"
          f" / {c['uncorrected']} uncorrected over {c['decode_steps']} "
          f"decode steps, {c['verify_calls']} verifies ({c['ecc_verifies']} "
          f"counted), repairs {c['repairs']}, scrub {c['scrub']}; ECC verify"
          f" {c['verify_ms_per_step']:.2f} ms a decode step (CUDA events "
          f"around each verify); {c['tok_s']:.4f} tok/s; peak {peak:.2f} "
          f"GiB")

    # the failover: a bank of the widened array killed mid-run
    spec = serve.resident_array_spec(model.cfg, args.slots,
                                     args.prompt_len + args.gen)
    assert spec.n_enabled > 1, spec
    t = time.perf_counter()
    serve.fresh_cim_state()
    try:
        fused.launches = 0
        with faults.faults(faults.FaultConfig(seed=5,
                                              kill_bank_at=KILL_BANK_AT)):
            kill = serve.serve_once(model_resident, args)
        out["launches"] += fused.launches
    finally:
        serve.fresh_cim_state()
    out["failover_s"] = time.perf_counter() - t
    kf = kill["faults"]
    assert kf["failovers"] == 1 and kf["dead_banks"] == [KILL_BANK_AT[1]], kf
    assert [r["token_ids"] for r in kill["per_request"]] == \
        out["sampler"]["tokens"]
    out["failover"] = {"kill_bank_at": list(KILL_BANK_AT),
                       "array": "widened (full width)",
                       "step_accesses": kill["step_accesses"],
                       "step_dispatches": kill["step_dispatches"],
                       "completed": kill["completed"]}
    print(f"failover: bank {KILL_BANK_AT[1]} of the widened array killed at "
          f"decode step {KILL_BANK_AT[0]}: tokens equal to the healthy run; "
          f"accesses per step {kill['step_accesses']}, dispatches "
          f"{kill['step_dispatches']}")
    print(f"adra phase: {out['launches']} fused launches")
    return out


def phase_hybrid_prefill(model, dev) -> dict:
    """The hybrid phase's recurrentgemma-9b model (weights and compute
    casts reused) through `serve.main` on the float path: 3 requests of a
    2040-token prompt and 8 tokens each on 2 slots, prompt + gen = the
    model's 2048-token window. Every request completes; the 26 RG-LRU
    layers launch once per prefill at (1, 2040, 4096), on the TMA kernel,
    and once per decode step, on the kernel `rglru.route` names; nothing
    reaches the ledger, the fused kernel or the sLSTM kernels. The prefill,
    decode and insert programs are captured as CUDA graphs (the first
    prefill eager, the second captured, the third replayed), and the run
    under `dispatch.eager_programs()` gives the same tokens and launches
    (`float_serve_eager`). Then one more prefill
    under torch.profiler (its RG-LRU device time beside its wall time),
    and single prefills in turns, the TMA kernel's and, with the routing
    threshold raised past the prompt, the one-thread-per-channel
    kernel's: tiles, rows, tiles, rows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.cim import accounting, fused_kernel
    from repro_torch.configs import preset_config
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import slstm as sm
    from repro_torch.launch import serve

    args = serve.parse_args(HYBRID_PREFILL)
    n_rec = model.kinds.count("rec")
    torch.cuda.reset_peak_memory_stats(dev)
    serve.fresh_cim_state()
    reset_launches()
    t = time.perf_counter()
    rep = serve.main(HYBRID_PREFILL, model=model)
    serve_s = time.perf_counter() - t
    all_launches = read_launches()
    launches = {"sm90": rg.rglru_sm90.launches,
                "rows": rg.rglru_rows.launches}
    other = (fused_kernel.fused_planes_op.launches, sm.launches())
    led = accounting.ledger()
    assert rep["completed"] == args.requests, rep["completed"]
    assert all(len(r["token_ids"]) == args.gen for r in rep["per_request"])
    want = rglru_expected(model, args.slots, args.prompt_len,
                          rep["requests"], rep["decode_steps"])
    assert launches == want, (launches, want)
    assert launches["sm90"] >= n_rec * args.requests, launches
    assert other == (0, 0), other
    assert (led.accesses, led.load_accesses, led.total_accesses) == (0, 0, 0)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    prefill_ms = [r["prefill_ms"] for r in rep["per_request"]]
    print(f"hybrid-prefill[recurrentgemma-9b float, prompt "
          f"{args.prompt_len} + gen {args.gen}]: prefill ms {prefill_ms} "
          f"(mean {rep['prefill_ms_mean']:.2f}), {rep['tok_s_steady']:.4f} "
          f"tok/s steady, p50 {rep['p50_ms']:.2f} ms, {rep['decode_steps']} "
          f"decode steps, wall {rep['wall_s']:.2f} s; rglru launches "
          f"{launches} = {n_rec} x {rep['requests']} prefills on sm90 + "
          f"{n_rec} x {rep['decode_steps']} decode steps; 0 fused, 0 slstm "
          f"launches, 0 ledger accesses; peak memory {peak_gib:.2f} GiB")
    graphed = float_serve_eager("hybrid-prefill", HYBRID_PREFILL, model, rep,
                                all_launches)

    fm = model.derive(preset_config(args.arch, args.preset))
    gen = torch.Generator().manual_seed(7)
    toks = torch.randint(0, fm.cfg.vocab_size, (1, args.prompt_len),
                         generator=gen).to(dev)
    max_len = args.prompt_len + args.gen
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fm.prefill({"tokens": toks}, max_len=max_len)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [(e.key, e.count, e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    busy_ms = sum(r[2] for r in kernels)
    rec = [r for r in kernels if "rglru" in r[0]]
    rglru_ms = sum(r[2] for r in rec)
    print(f"hybrid-prefill: one profiled prefill of {args.prompt_len} "
          f"tokens: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms; "
          f"RG-LRU {rglru_ms:.4f} ms device in "
          f"{sum(r[1] for r in rec)} launches ({rglru_ms / wall_ms:.5f} of "
          f"the wall) {[r[0][:60] for r in rec]}")
    for name, count, ms in sorted(kernels, key=lambda r: -r[2])[:6]:
        print(f"profile:   {ms:10.3f} ms  x{count:<6d} {name[:90]}")

    def one_prefill() -> float:
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        fm.prefill({"tokens": toks}, max_len=max_len)
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t) * 1e3

    turns = {"sm90": [], "rows": []}
    min_t = rg.SM90_MIN_T
    try:
        for kernel in ("sm90", "rows", "sm90", "rows"):
            rg.SM90_MIN_T = min_t if kernel == "sm90" else args.prompt_len + 1
            before = rg.launches()
            rows0 = rg.rglru_rows.launches
            turns[kernel].append(one_prefill())
            moved = (rg.launches() - before, rg.rglru_rows.launches - rows0)
            assert moved == (n_rec, n_rec if kernel == "rows" else 0), moved
    finally:
        rg.SM90_MIN_T = min_t
    gain = (sum(turns["rows"]) - sum(turns["sm90"])) / 2
    print(f"hybrid-prefill: single prefills in turns, RG-LRU on the TMA "
          f"kernel {turns['sm90']} ms, on the rows kernel {turns['rows']} "
          f"ms: {gain:.2f} ms less a prefill on the TMA kernel")
    return {"launches": launches, "prefill_ms": prefill_ms,
            "prefill_ms_mean": rep["prefill_ms_mean"],
            "tok_s_steady": rep["tok_s_steady"], "peak_gib": peak_gib,
            "profiled_wall_ms": wall_ms, "profiled_busy_ms": busy_ms,
            "profiled_rglru_ms": rglru_ms, "serve_s": serve_s,
            "prefill_turns_ms": turns, "prefill_gain_ms": gain,
            "graphed": graphed}


def phase_xlstm(dev, profile: bool) -> dict:
    """xlstm-125m at full width through `serve.main` on the float path:
    every request completes, each sLSTM layer launches its kernel once per
    prefill and once per decode step, every launch on the persistent-grid
    kernel (cooperative, captured into the decode step's CUDA graph), and
    nothing reaches the CiM ledger, the fused kernel or the RG-LRU kernel;
    the prefill, decode and insert programs captured and replayed, and the
    same run under `dispatch.eager_programs()` gives the same tokens and
    launches."""
    import torch
    from repro_torch.cim import accounting, fused_kernel
    from repro_torch.configs import preset_config
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import slstm as sm
    from repro_torch.launch import serve
    from repro_torch.models.model import build

    args = serve.parse_args(XLSTM_SERVE)
    times = {}
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    model = build(preset_config(args.arch, args.preset), device=dev,
                  seed=args.seed, for_serving=True)
    torch.cuda.synchronize()
    times["init_s"] = time.perf_counter() - t
    n_params = sum(p.numel() for p in model.parameters())
    n_slstm = model.kinds.count("slstm")

    t = time.perf_counter()
    serve.fresh_cim_state()
    reset_launches()
    rep = serve.main(XLSTM_SERVE, model=model)
    all_launches = read_launches()
    slstm_launches = sm.launches()
    sm90_launches = sm.slstm_sm90.launches
    fused_launches = fused_kernel.fused_planes_op.launches
    rglru_launches = rg.launches()
    times["serve_s"] = time.perf_counter() - t
    led = accounting.ledger()
    assert rep["completed"] == args.requests, rep["completed"]
    assert all(len(r["token_ids"]) == args.gen for r in rep["per_request"])
    want = n_slstm * (rep["decode_steps"] + rep["requests"])
    assert slstm_launches == want > 0, (slstm_launches, want)
    assert sm90_launches == slstm_launches, (sm90_launches, slstm_launches)
    assert fused_launches == 0 and rglru_launches == 0, \
        (fused_launches, rglru_launches)
    assert (led.accesses, led.load_accesses, led.total_accesses) == (0, 0, 0)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"xlstm-125m: {n_params} parameters, {rep['tok_s_steady']:.4f} "
          f"tok/s steady, p50 {rep['p50_ms']:.3f} ms, p99 "
          f"{rep['p99_ms']:.3f} ms, prefill {rep['prefill_ms_mean']:.2f} ms "
          f"mean ({args.prompt_len} tokens), {rep['decode_steps']} decode "
          f"steps, wall {rep['wall_s']:.2f} s; {slstm_launches} slstm "
          f"launches = {n_slstm} x ({rep['decode_steps']} decode steps + "
          f"{rep['requests']} prefills), {sm90_launches} on the sm90 "
          f"kernel; 0 fused, 0 rglru launches, 0 ledger "
          f"accesses; peak memory {peak_gib:.2f} GiB")
    print(f"xlstm-125m tokens: {[r['token_ids'] for r in rep['per_request']]}")
    t = time.perf_counter()
    graphed = float_serve_eager("xlstm-125m", XLSTM_SERVE, model, rep,
                                all_launches)
    times["eager_s"] = time.perf_counter() - t
    if profile:
        t = time.perf_counter()
        phase_profile(model, dev, args.prompt_len + args.gen, args.prompt_len)
        times["profile_s"] = time.perf_counter() - t
    return {"slstm_launches": slstm_launches,
            "sm90_launches": sm90_launches,
            "prefill_ms": rep["prefill_ms_mean"],
            "tok_s_steady": rep["tok_s_steady"],
            "peak_gib": peak_gib, "graphed": graphed, "times": times}


def phase_agree(dev, prompt_len: int = 512, steps: int = 8) -> dict:
    """xlstm-125m's float32 path on the card against the port on the CPU,
    on the same weights (the xLSTM serve's seed, float32 throughout): one
    prompt, then greedy decode steps on each side. Tokens must be equal;
    logits within AGREE_ATOL. The CPU side runs on one intra-op thread, as
    the CPU tests do."""
    import torch
    from repro_torch.configs import preset_config
    from repro_torch.launch import serve
    from repro_torch.models.model import Model, build

    args = serve.parse_args(XLSTM_SERVE)
    cfg = dataclasses.replace(preset_config(args.arch, args.preset),
                              dtype="float32")
    card = build(cfg, device=dev, seed=args.seed)

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cpu(v) for v in tree]
        return tree.detach().to("cpu", copy=True)

    host = Model(cfg, params=to_cpu(card.params()))
    gen = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen)

    def greedy(m):
        dev_m = m.device
        caches, logits = m.prefill({"tokens": prompt.to(dev_m)},
                                   max_len=prompt_len + steps)
        all_logits, toks = [logits.cpu()], [int(logits.argmax(-1)[0])]
        for i in range(steps):
            caches, logits = m.decode_step(caches, {
                "tokens": torch.tensor([[toks[-1]]], device=dev_m),
                "positions": torch.tensor([prompt_len + i],
                                          dtype=torch.int32, device=dev_m)})
            all_logits.append(logits.cpu())
            toks.append(int(logits.argmax(-1)[0]))
        return toks, torch.cat(all_logits)

    t = time.perf_counter()
    card_toks, card_logits = greedy(card)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    t = time.perf_counter()
    try:
        host_toks, host_logits = greedy(host)
    finally:
        torch.set_num_threads(n_threads)
    host_s = time.perf_counter() - t
    err = float((card_logits - host_logits).abs().max())
    print(f"agree[xlstm-125m f32]: card tokens {card_toks}, cpu tokens "
          f"{host_toks}; logits max abs diff {err:.3e} (atol {AGREE_ATOL:g});"
          f" card {card_s:.2f} s, cpu {host_s:.2f} s")
    assert card_toks == host_toks, (card_toks, host_toks)
    assert err <= AGREE_ATOL, err
    return {"max_logit_diff": err, "tokens": card_toks}


def phase_train(dev, profile: bool) -> dict:
    """gemma-2b at full width through `repro_torch.launch.train`'s entry
    point: 4 steps of batch 2 x 2048 tokens in 2 microbatches with
    per-layer recomputation, under the Supervisor. Every earlier phase's
    model must be gone (the hybrid peaks at 74 GiB, this state alone is
    40 GB). Asserts finite losses, no restart, the flash kernel launched
    once per layer, microbatch and pass (forward and recomputation), and
    no launch of the serve paths' kernels. The step is captured as one
    CUDA graph at step 2 and replayed at steps 3 and 4; the same 4 steps
    under `dispatch.eager_programs()` from the same weights give the same
    losses to the bit (`train_eager`)."""
    import math

    import torch
    from repro_torch.cim import fused_kernel
    from repro_torch.configs import preset_config
    from repro_torch.kernels import flash_attention as fm
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import slstm as sm
    from repro_torch.launch import train
    from repro_torch.models.model import build

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    assert held < 2 ** 30, f"{held} bytes still allocated before training"
    args = train.parse_args(TRAIN)
    cfg = preset_config(args.arch, args.preset)
    assert args.ckpt_every > args.steps      # a checkpoint here is 40 GB
    per_step = cfg.n_layers * cfg.microbatches * (2 if cfg.remat else 1)
    model = build(cfg, device=dev, seed=args.seed)
    fused_kernel.fused_planes_op.launches = 0
    rg.rglru_sm90.launches = rg.rglru_rows.launches = 0
    sm.slstm_sm90.launches = sm.slstm_rows.launches = 0
    fm.flash_attention_sm90.launches = 0
    fm.flash_attention_simt.launches = 0
    rep = train.main(TRAIN, model=model)
    all_launches = read_launches()
    flash_launches = fm.launches()
    sm90_launches = fm.flash_attention_sm90.launches
    simt_launches = fm.flash_attention_simt.launches
    other = (fused_kernel.fused_planes_op.launches, rg.launches(),
             sm.launches())
    losses = [r["loss"] for r in rep["records"]]
    assert len(losses) == args.steps and rep["restarts"] == 0, rep
    assert all(math.isfinite(x) for x in losses), losses
    assert flash_launches == rep["flash_launches"] == per_step * args.steps, \
        (flash_launches, per_step)
    # every launch on the bf16 wgmma/TMA kernel
    assert (sm90_launches, simt_launches) == (flash_launches, 0), \
        (sm90_launches, simt_launches)
    assert other == (0, 0, 0), other
    ms = [r["ms"] for r in rep["records"]]
    print(f"train[gemma-2b full]: {rep['n_params']} parameters; losses "
          f"{losses}; step ms {[round(x, 2) for x in ms]}; steady "
          f"{rep['tok_s_steady']:.2f} tokens/s; {flash_launches} flash "
          f"launches = {per_step} per step x {args.steps}, {sm90_launches} "
          f"on the wgmma/TMA kernel, {simt_launches} SIMT; 0 fused, rglru, "
          f"slstm launches; peak memory {rep['peak_gib']:.2f} GiB")
    if profile:
        profile_train_step(model, args, dev)
    del model
    graphed = train_eager("train[gemma-2b full]", TRAIN,
                          lambda: build(cfg, device=dev, seed=args.seed),
                          rep, all_launches, dev)
    return {"flash_launches": flash_launches, "per_step": per_step,
            "sm90_launches": sm90_launches, "simt_launches": simt_launches,
            "losses": losses, "step_ms": ms,
            "tok_s_steady": rep["tok_s_steady"], "peak_gib": rep["peak_gib"],
            "graphed": graphed}


def profile_train_step(model, args, dev) -> None:
    """One more train step of the trained model (fresh optimizer state)
    under torch.profiler: device time by kernel and PyTorch op, and the
    device's idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_state, make_train_step

    opt = AdamWConfig(lr=args.lr)
    state = init_state(model, opt)
    step = make_train_step(model, opt)
    dcfg = DataConfig(vocab_size=model.cfg.vocab_size, batch=args.batch,
                      seq_len=args.seq)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_batch(args.steps, dcfg).items()}
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    kernels = [(e.key, e.count, e.self_device_time_total / 1e3)
               for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    ops = [(e.key, e.count, e.self_device_time_total / 1e3)
           for e in events if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    busy_ms = sum(r[2] for r in kernels)
    flash = [r for r in kernels if "flash_attention" in r[0]]
    print(f"profile[train {model.cfg.name}]: step wall {wall_ms:.2f} ms, "
          f"device busy {busy_ms:.2f} ms (idle share "
          f"{1 - busy_ms / wall_ms:.3f})")
    for name, count, ms in sorted(flash + ops, key=lambda r: -r[2])[:14]:
        print(f"profile:   {ms:10.3f} ms  x{count:<6d} {name[:90]}")
    for name, count, ms in flash:       # however far down the list
        print(f"profile: flash {ms:.3f} ms x{count} ({ms / count:.4f} ms a "
              f"launch, {ms / busy_ms:.4f} of busy) {name[:90]}")
    del state


def phase_train_agree(dev) -> dict:
    """gemma's attention shape (8 x 1 heads of 256) at a depth and vocab the
    CPU affords, float32, remat on, 2 microbatches of 1 x 1024: the card
    (the flash kernel) and the CPU (the plain versions) from the same
    weights and batches, at a constant lr.

    Checks, with tolerances stated before the run they judge:
      1. the first batch's gradients, leaf by leaf, within 1e-4 relative L2
         (float32 sums in other orders; chip run 3 measured at most 3.6e-6):
         the flash forward and blockwise backward through the whole model;
      2. two train steps: losses within 1e-4, grad norms within 1e-3
         relative, and every parameter within 2 lr per step, with the two
         runs' updates within 5e-2 relative L2. These are looser than 1.:
         Adam's early steps are about lr sign(g), so an element whose
         gradient lies within summation noise of 0 steps either way, and
         the reference's CE gradient (which the port keeps) adds +1 at each
         row's argmax, which a near tie flips: on the CPU alone, moving 30
         elements per leaf by 1e-4 after step 1 moved the step-2 gradient
         by 1.9% (chip run 2 failed its first-stated 1e-2 on the updates at
         1.44e-2 for this reason, ROADMAP C)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.kernels import flash_attention as fm
    from repro_torch.models.model import Model, build
    from repro_torch import tree
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.step import accumulate_grads

    cfg = dataclasses.replace(
        get_config("gemma-2b"), name="gemma-2b-agree", n_layers=2,
        d_model=512, d_ff=2048, vocab_size=4096, dtype="float32",
        remat=True, microbatches=2)
    lr, steps = 1e-3, 2
    host = build(cfg, device="cpu", seed=0)

    def copy(node, device):
        if isinstance(node, dict):
            return {k: copy(v, device) for k, v in node.items()}
        if isinstance(node, list):
            return [copy(v, device) for v in node]
        return node.detach().to(device, copy=True)

    before = [t.clone() for t in tree.leaves(host.params())]
    card = Model(cfg, params=copy(host.params(), dev))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, batch=2, seq_len=1024)
    out = {}
    for name, model in (("card", card), ("cpu", host)):
        opt = AdamWConfig(lr=lr)
        state = init_state(model, opt)
        step = make_train_step(model, opt)
        launches0 = fm.launches()
        simt0 = fm.flash_attention_simt.launches
        t = time.perf_counter()
        batches = [{k: torch.from_numpy(v).to(model.device)
                    for k, v in synthetic_batch(s, dcfg).items()}
                   for s in range(steps)]
        accumulate_grads(model, batches[0], cfg.microbatches)
        grads = [p.grad.detach().cpu().clone()
                 for p in tree.leaves(model.params())]
        mets = []
        for batch in batches:
            state, m = step(state, batch)
            mets.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        if name == "card":
            torch.cuda.synchronize(dev)
        out[name] = dict(metrics=mets, s=time.perf_counter() - t,
                         grads=grads,
                         launches=fm.launches() - launches0,
                         simt=fm.flash_attention_simt.launches - simt0,
                         params=[p.detach().cpu()
                                 for p in tree.leaves(model.params())])
    # two launches per layer and microbatch (forward and recomputation) in
    # the gradient pass and in each train step
    want = cfg.n_layers * cfg.microbatches * 2 * (steps + 1)
    assert out["card"]["launches"] == want, (out["card"]["launches"], want)
    assert out["card"]["simt"] == want, out["card"]["simt"]   # float32
    assert out["cpu"]["launches"] == 0
    grad_rel = max(float(torch.linalg.vector_norm(a - b)
                         / torch.linalg.vector_norm(b))
                   for a, b in zip(out["card"]["grads"], out["cpu"]["grads"]))
    loss_d = max(abs(a["loss"] - b["loss"]) for a, b in
                 zip(out["card"]["metrics"], out["cpu"]["metrics"]))
    gn_d = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
               for a, b in zip(out["card"]["metrics"], out["cpu"]["metrics"]))
    upd_c = torch.cat([(p - p0).flatten() for p, p0
                       in zip(out["card"]["params"], before)])
    upd_h = torch.cat([(p - p0).flatten() for p, p0
                       in zip(out["cpu"]["params"], before)])
    diff = (upd_c - upd_h).abs()
    upd_rel = float(torch.linalg.vector_norm(upd_c - upd_h)
                    / torch.linalg.vector_norm(upd_h))
    print(f"train-agree[2 layers, d 512, 8x1 heads of 256, vocab 4096, f32, "
          f"seq 1024]: card {out['card']['metrics']} ({out['card']['s']:.2f}"
          f" s, {out['card']['launches']} flash launches), cpu "
          f"{out['cpu']['metrics']} ({out['cpu']['s']:.2f} s); first-batch "
          f"gradients max leaf rel L2 {grad_rel:.3e} (tol 1e-4); loss diff "
          f"{loss_d:.3e} (tol 1e-4), grad-norm rel diff {gn_d:.3e} (tol "
          f"1e-3), update rel L2 {upd_rel:.3e} (tol 5e-2), max element diff "
          f"{float(diff.max()):.3e} (tol {2 * lr * steps:g}), "
          f"{int((diff > 1e-5).sum())} of {diff.numel()} elements beyond "
          f"1e-5")
    assert grad_rel <= 1e-4, grad_rel
    assert loss_d <= 1e-4 and gn_d <= 1e-3, (loss_d, gn_d)
    assert upd_rel <= 5e-2 and float(diff.max()) <= 2 * lr * steps, \
        (upd_rel, float(diff.max()))
    return {"grad_rel_l2": grad_rel, "loss_diff": loss_d,
            "grad_norm_rel_diff": gn_d, "update_rel_l2": upd_rel,
            "max_param_diff": float(diff.max())}


#: the configs phase: the registry's other families at full width
CONFIG_SERVE_ARGS = ["--requests", "2", "--gen", "4"]
CONFIG_PATHS = {
    # 16 layers x [K = 2048, 2048, 8192 (MLP), 64 (QK^T), 12 (AV: Tmax 12)]
    "llama3.2-1b": dict(args=CONFIG_SERVE_ARGS,
                        step_accesses=16 * (26 + 26 + 28 + 21 + 19),
                        step_dispatches=16 * 5),
    # layer 0's dense MLP alone, K = 2048, 2048, 10944; the 26 MoE layers
    # and MLA are float, as in the reference
    "deepseek-v2-lite-16b": dict(args=CONFIG_SERVE_ARGS,
                                 step_accesses=26 + 26 + 29,
                                 step_dispatches=3),
}
#: the float path at full width (2 slots, 2 requests, prompt 8 + gen 12:
#: decode step 1 runs the decode program eagerly and step 2 captures it,
#: so 12 tokens leave 9 replayed steps in the steady window);
#: musicgen-large and internvl2-26b take embed-stub inputs
CONFIG_FLOAT = ("qwen3-14b", "granite-3-8b", "musicgen-large",
                "internvl2-26b")
CONFIG_FLOAT_ARGS = ["--requests", "2", "--gen", "12"]
#: llama3.2-1b's training: 4 steps, so that steps 3 and 4 replay the step
#: graph step 2 captured
CONFIG_TRAIN = ["--arch", "llama3.2-1b", "--preset", "full", "--device",
                "cuda", "--steps", "4", "--batch", "2", "--seq", "2048",
                "--ckpt-every", "1000", "--log-every", "1"]
#: card-vs-CPU tolerance of the float32 reduced agreements (deepseek's
#: serve and train step, the hybrid's and xLSTM's train step)
CONFIG_AGREE_ATOL = 1e-4
#: the recurrent families' train path at full width through the train
#: entry point, 4 steps of 2 x 1024: xlstm-125m whole; recurrentgemma-9b
#: cut to one pattern period (rec, rec, local: 3 of its 38 layers; the
#: whole model's float32 weights, gradients and moments would take 144
#: GB). 1024 positions, not 2048: the sLSTM backward reruns its plain
#: version one step at a time (8.2 s a step at 2048 on an H100 SXM)
CONFIG_RECURRENT_TRAIN = {"xlstm-125m": None, "recurrentgemma-9b": 3}
CONFIG_RECURRENT_ARGS = ["--preset", "full", "--device", "cuda", "--steps",
                         "4", "--batch", "2", "--seq", "1024",
                         "--ckpt-every", "1000", "--log-every", "1"]


def with_steps(argv, n: int) -> list:
    """A train entry point's arguments with `--steps n`."""
    argv = list(argv)
    argv[argv.index("--steps") + 1] = str(n)
    return argv


def _free(dev) -> int:
    """Drop what the last model left and return the bytes still held."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(dev)


def phase_configs(dev, profile: bool = False) -> dict:
    """The seven configs the earlier phases do not run, through the port's
    serve and train entry points, one model on the card at a time:
      (a) llama3.2-1b at full width, int8 CiM decode (repack, resident,
          warm, host twin), 1920 accesses and 80 dispatches a step;
      (b) deepseek-v2-lite-16b at full width the same way: 81 accesses and
          3 dispatches a step (layer 0's dense MLP; MoE and MLA float);
      (c) qwen3-14b, granite-3-8b, musicgen-large and internvl2-26b at full
          width on the float path (built as serve.main builds them: cast
          layer weights in bf16 only), 12 tokens each: every request
          completes, 0 ledger accesses, 0 kernel launches; the prefill,
          decode and insert programs captured and replayed, and the same
          run under `dispatch.eager_programs()` gives the same tokens;
      (d) llama3.2-1b training at full width, 4 steps of 2 x 2048: finite
          losses, 16 x 2 flash launches a step, all on the wgmma/TMA
          kernel; the step captured as one CUDA graph and replayed, its
          losses equal to the bit to the same steps under
          `dispatch.eager_programs()`;
      (e) reduced deepseek-v2-lite-16b in float32 on the card against the
          CPU from the same weights: prefill, 4 greedy decode steps, the
          first batch's loss and gradients within CONFIG_AGREE_ATOL;
      (f) the hybrid's and xLSTM's train path (CONFIG_RECURRENT_TRAIN):
          4 steps, finite losses, the RG-LRU and sLSTM kernels launched
          once per recurrent layer, microbatch and forward (remat: twice),
          no flash launch, losses equal to the bit to eager steps (the
          step graph replays the cooperative sLSTM launch); then both
          reduced in float32, the card's loss
          and gradients (kernel forward, plain-version backward) against
          the CPU's within CONFIG_AGREE_ATOL.
    grok-1-314b (628 GB of bf16 parameters) runs reduced only, in the CPU
    tests. Each model's peak device memory is printed. With `profile`, (a)
    and (b) also profile one warm resident decode step each."""
    import math

    import torch
    from repro_torch.cim import accounting, fused_kernel
    from repro_torch.configs import preset_config
    from repro_torch.kernels import flash_attention as fm
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import slstm as sm
    from repro_torch.launch import serve, train
    from repro_torch.models.model import build

    torch.empty(0, device=dev)      # a context, when the phase runs alone
    out = {"peak_gib": {}, "serve": {}, "times": {}, "graphs": {}}
    for arch, spec in CONFIG_PATHS.items():
        t = time.perf_counter()
        run = phase_serve(arch, dev, profile, spec=spec)
        del run["model"]
        held = _free(dev)
        out["serve"][arch] = {k: run[k] for k in ("fused_launches",
                                                   "peak_gib")}
        out["peak_gib"][arch] = run["peak_gib"]
        out["graphs"][arch] = run["graphs"]
        out["times"][arch] = time.perf_counter() - t
        print(f"configs[{arch}]: {out['times'][arch]:.1f} s, "
              f"{held} bytes held after")
    fused_launches = sum(r["fused_launches"] for r in out["serve"].values())

    out["float_graphs"] = {}
    for arch in CONFIG_FLOAT:
        t = time.perf_counter()
        argv = ["--arch", arch, "--preset", "full", "--device", "cuda",
                "--slots", "2", "--prompt-len", "8"] + CONFIG_FLOAT_ARGS
        assert _free(dev) < 2 ** 30
        torch.cuda.reset_peak_memory_stats(dev)
        serve.fresh_cim_state()
        args = serve.parse_args(argv)
        # the model serve.main builds, kept for the eager run
        model = build(preset_config(arch, args.preset), device=dev,
                      seed=args.seed, for_serving=True)
        reset_launches()
        rep = serve.main(argv, model=model)
        all_launches = read_launches()
        counts = (fused_kernel.fused_planes_op.launches, rg.launches(),
                  sm.launches(), fm.launches())
        led = accounting.ledger()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        assert rep["completed"] == args.requests, (arch, rep["completed"])
        assert all(len(r["token_ids"]) == args.gen
                   for r in rep["per_request"]), arch
        assert (led.accesses, led.load_accesses) == (0, 0), arch
        assert counts == (0, 0, 0, 0), (arch, counts)
        assert peak < 80, (arch, peak)
        out["peak_gib"][arch] = peak
        out["serve"][arch] = {k: rep[k] for k in (
            "tok_s_steady", "p50_ms", "p99_ms", "prefill_ms_mean",
            "decode_steps")}
        print(f"configs[{arch} float]: {rep['tok_s_steady']:.4f} tok/s "
              f"steady, p50 {rep['p50_ms']:.2f} ms, prefill "
              f"{rep['prefill_ms_mean']:.1f} ms mean, "
              f"{rep['decode_steps']} decode steps, {rep['completed']} of "
              f"{args.requests} requests, 0 ledger accesses, 0 kernel "
              f"launches; peak memory {peak:.2f} GiB; "
              f"tokens {[r['token_ids'] for r in rep['per_request']]}")
        out["float_graphs"][arch] = float_serve_eager(
            f"configs[{arch} float]", argv, model, rep, all_launches)
        out["times"][arch] = time.perf_counter() - t
        del rep, model

    t = time.perf_counter()
    held = _free(dev)
    assert held < 2 ** 30, f"{held} bytes still allocated before training"
    targs = train.parse_args(CONFIG_TRAIN)
    cfg = preset_config(targs.arch, targs.preset)
    per_step = cfg.n_layers * cfg.microbatches * (2 if cfg.remat else 1)
    reset_launches()
    trep = train.main(CONFIG_TRAIN)
    all_launches = read_launches()
    flash_launches = fm.launches()
    sm90 = fm.flash_attention_sm90.launches
    losses = [r["loss"] for r in trep["records"]]
    assert len(losses) == targs.steps and trep["restarts"] == 0, trep
    assert all(math.isfinite(x) for x in losses), losses
    assert flash_launches == per_step * targs.steps == 32 * targs.steps, \
        (flash_launches, per_step)
    assert sm90 == flash_launches, (sm90, flash_launches)
    assert fused_kernel.fused_planes_op.launches == 0
    out["peak_gib"]["llama3.2-1b train"] = trep["peak_gib"]
    out["train"] = {"losses": losses, "step_ms": [r["ms"] for r in
                                                  trep["records"]],
                    "tok_s_steady": trep["tok_s_steady"],
                    "flash_launches": flash_launches, "per_step": per_step}
    out["times"]["llama3.2-1b train"] = time.perf_counter() - t
    print(f"configs[llama3.2-1b train]: {trep['n_params']} parameters; "
          f"losses {losses}; step ms "
          f"{[round(r['ms'], 2) for r in trep['records']]}; "
          f"{flash_launches} flash launches = {per_step} per step x "
          f"{targs.steps}, {sm90} on the wgmma/TMA kernel; peak memory "
          f"{trep['peak_gib']:.2f} GiB")
    out["train"]["graphed"] = train_eager(
        "configs[llama3.2-1b train]", CONFIG_TRAIN,
        lambda: build(cfg, device=dev, seed=targs.seed), trep, all_launches,
        dev)
    del trep
    _free(dev)

    t = time.perf_counter()
    out["agree"] = configs_agree(dev)
    out["times"]["deepseek agree"] = time.perf_counter() - t

    out["recurrent_train"] = {}
    split = {"rglru_sm90": 0, "rglru_rows": 0, "slstm_sm90": 0,
             "slstm_rows": 0}
    for arch, layers in CONFIG_RECURRENT_TRAIN.items():
        t = time.perf_counter()
        held = _free(dev)
        assert held < 2 ** 30, f"{held} bytes still allocated before {arch}"
        cfg = preset_config(arch, "full")
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        model = build(cfg, device=dev, seed=0)
        argv = ["--arch", arch] + CONFIG_RECURRENT_ARGS
        targs = train.parse_args(argv)
        per = cfg.microbatches * (2 if cfg.remat else 1)
        want = {"rglru": model.kinds.count("rec") * per * targs.steps,
                "slstm": model.kinds.count("slstm") * per * targs.steps}
        reset_launches()
        trep = train.main(argv, model=model)
        all_launches = read_launches()
        got = {"rglru": rg.launches(), "slstm": sm.launches()}
        losses = [r["loss"] for r in trep["records"]]
        assert len(losses) == targs.steps and trep["restarts"] == 0, trep
        assert all(math.isfinite(x) for x in losses), (arch, losses)
        assert got == want, (arch, got, want)
        assert fm.launches() == 0, (arch, fm.launches())
        for k, n in launch_split().items():
            split[k] += n
        key = f"{arch} train" + ("" if layers is None else f" ({layers} "
                                                            f"layers)")
        out["peak_gib"][key] = trep["peak_gib"]
        out["recurrent_train"][arch] = {
            "layers": len(model.kinds), "n_params": trep["n_params"],
            "losses": losses, "step_ms": [r["ms"] for r in trep["records"]],
            "tok_s_steady": trep["tok_s_steady"], "launches": got}
        out["times"][key] = time.perf_counter() - t
        print(f"configs[{key}]: {trep['n_params']} parameters; losses "
              f"{losses}; step ms "
              f"{[round(r['ms'], 2) for r in trep['records']]}; launches "
              f"{got} (rglru sm90 {rg.rglru_sm90.launches}, slstm sm90 "
              f"{sm.slstm_sm90.launches}), 0 flash; peak memory "
              f"{trep['peak_gib']:.2f} GiB; {out['times'][key]:.1f} s")
        del model
        out["recurrent_train"][arch]["graphed"] = train_eager(
            f"configs[{key}]", argv,
            lambda: build(cfg, device=dev, seed=0), trep, all_launches, dev)
        del trep
    _free(dev)
    t = time.perf_counter()
    out["recurrent_agree"] = recurrent_agree(dev)
    out["times"]["recurrent agree"] = time.perf_counter() - t
    out["fused_launches"] = fused_launches
    out["flash_launches"] = flash_launches
    for arch in CONFIG_RECURRENT_TRAIN:
        for k, n in out["recurrent_agree"][arch]["split"].items():
            split[k] += n
    out["recurrent_launches"] = split
    return out


def launch_split() -> dict:
    """The RG-LRU and sLSTM kernels' launch counts, per kernel."""
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import slstm as sm
    return {"rglru_sm90": rg.rglru_sm90.launches,
            "rglru_rows": rg.rglru_rows.launches,
            "slstm_sm90": sm.slstm_sm90.launches,
            "slstm_rows": sm.slstm_rows.launches}


def recurrent_agree(dev, seq: int = 64) -> dict:
    """Reduced recurrentgemma-9b and xlstm-125m in float32 on the card and
    on the CPU from the same weights: the first batch (2 x `seq`) gives the
    same loss and every gradient within CONFIG_AGREE_ATOL. On the card the
    RG-LRU and sLSTM kernels run the forward (one launch per recurrent
    layer) and their backward reruns the plain versions; on the CPU the
    plain versions run both. The CPU side runs on one intra-op thread."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import slstm as sm
    from repro_torch.models.model import Model, build

    out = {}
    for arch, kind, mod in (("recurrentgemma-9b", "rec", rg),
                            ("xlstm-125m", "slstm", sm)):
        cfg = get_config(arch).reduced()
        host = build(cfg, device="cpu", seed=0)
        card = Model(cfg, params=tree.tree_map(
            lambda p: p.detach().to(dev, copy=True), host.params()))
        batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
            0, DataConfig(vocab_size=cfg.vocab_size, batch=2,
                          seq_len=seq)).items()}

        def run(m):
            leaves = tree.leaves(m.params())
            for p in leaves:
                p.requires_grad_(True)
                p.grad = None
            loss, _ = m.loss({k: v.to(m.device) for k, v in batch.items()})
            loss.backward()
            return float(loss.detach()), [p.grad.detach().cpu()
                                          for p in leaves]

        rg.rglru_sm90.launches = rg.rglru_rows.launches = 0
        sm.slstm_sm90.launches = sm.slstm_rows.launches = 0
        c = run(card)
        torch.cuda.synchronize(dev)
        launches = mod.launches()
        split = launch_split()
        n_threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            h = run(host)
        finally:
            torch.set_num_threads(n_threads)
        loss_d = abs(c[0] - h[0])
        grad_d = max(float((a - b).abs().max()) for a, b in zip(c[1], h[1]))
        out[arch] = {"loss_diff": loss_d, "max_grad_diff": grad_d,
                     "n_grads": len(c[1]), "launches": launches,
                     "split": split}
        print(f"configs[{arch} reduced f32 train agree]: loss {c[0]:.6f} vs "
              f"{h[0]:.6f}, {len(c[1])} gradients max abs diff "
              f"{grad_d:.3e} (atol {CONFIG_AGREE_ATOL:g}); {launches} "
              f"{kind} kernel launches")
        assert launches == card.kinds.count(kind) > 0, (arch, launches)
        assert loss_d <= CONFIG_AGREE_ATOL, (arch, loss_d)
        assert grad_d <= CONFIG_AGREE_ATOL, (arch, grad_d)
    return out


def configs_agree(dev, steps: int = 4) -> dict:
    """Reduced deepseek-v2-lite-16b (MLA, one dense layer, MoE with the
    published capacity factor, so drops happen) in float32 on the card and
    on the CPU from the same weights: prefill and `steps` greedy decode
    steps give equal tokens and logits, and the first batch's loss and
    every gradient agree, within CONFIG_AGREE_ATOL. The scatter dispatch
    (`index_put_(accumulate=True)`) and its backward are the device-specific
    code here. The CPU side runs on one intra-op thread."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.models.model import Model, build

    cfg = get_config("deepseek-v2-lite-16b").reduced()
    host = build(cfg, device="cpu", seed=0)

    def copy(node, device):
        if isinstance(node, dict):
            return {k: copy(v, device) for k, v in node.items()}
        if isinstance(node, list):
            return [copy(v, device) for v in node]
        return node.detach().to(device, copy=True)

    card = Model(cfg, params=copy(host.params(), dev))
    gen = torch.Generator().manual_seed(11)
    prompt = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
        0, DataConfig(vocab_size=cfg.vocab_size, batch=2, seq_len=32))
        .items()}

    def run(m):
        d = m.device
        caches, logits = m.prefill({"tokens": prompt.to(d)},
                                   max_len=12 + steps)
        all_logits, toks = [logits.cpu()], [logits.argmax(-1).cpu()]
        for i in range(steps):
            caches, logits = m.decode_step(caches, {
                "tokens": toks[-1][:, None].to(d),
                "positions": torch.full((2,), 12 + i, dtype=torch.int32,
                                        device=d)})
            all_logits.append(logits.cpu())
            toks.append(logits.argmax(-1).cpu())
        leaves = tree.leaves(m.params())
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        loss, parts = m.loss({k: v.to(d) for k, v in batch.items()})
        loss.backward()
        grads = [p.grad.detach().cpu() for p in leaves]
        return (torch.stack(toks), torch.cat(all_logits),
                float(loss.detach()), float(parts["aux"].detach()), grads)

    c = run(card)
    torch.cuda.synchronize(dev)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        h = run(host)
    finally:
        torch.set_num_threads(n_threads)
    logit_d = float((c[1] - h[1]).abs().max())
    grad_d = max(float((a - b).abs().max()) for a, b in zip(c[4], h[4]))
    res = {"tokens_equal": bool(torch.equal(c[0], h[0])),
           "max_logit_diff": logit_d, "loss_diff": abs(c[2] - h[2]),
           "aux_diff": abs(c[3] - h[3]), "max_grad_diff": grad_d,
           "n_grads": len(c[4])}
    print(f"configs[deepseek-v2-lite-16b reduced f32 agree]: tokens equal "
          f"{res['tokens_equal']}, logits max abs diff {logit_d:.3e}, loss "
          f"{c[2]:.6f} vs {h[2]:.6f}, aux {c[3]:.6f} vs {h[3]:.6f}, "
          f"{len(c[4])} gradients max abs diff {grad_d:.3e} (atol "
          f"{CONFIG_AGREE_ATOL:g})")
    assert res["tokens_equal"], (c[0], h[0])
    assert logit_d <= CONFIG_AGREE_ATOL, logit_d
    assert res["loss_diff"] <= CONFIG_AGREE_ATOL, res
    assert res["aux_diff"] <= CONFIG_AGREE_ATOL, res
    assert grad_d <= CONFIG_AGREE_ATOL, grad_d
    return res


#: the mesh phase's one-cell dry run (256 fake ranks, 16x16)
MESH_DRYRUN = ("llama3.2-1b", "decode_32k", "single")
#: the RG-LRU block's input at a tensor-parallel rank: the hybrid's 2040-
#: token prefill, split over 16 and over 2 "model" ranks by channel
MESH_RANK_RGLRU = ((1, 2040, 4096), (16, 2))
#: flash at a rank's heads: (name, (B, T, T, Hq, Hkv, D), "model" ranks
#: whose specs split attention by head); each rank reads its block of query
#: heads and the kv heads they share (`attention.gqa_heads_tp`)
MESH_RANK_FLASH = [("gemma-2b", FLASH_TRAIN_SHAPE, (2,)),
                   ("llama3.2-1b", FLASH_LLAMA_TRAIN_SHAPE, (2, 16))]
#: calls of each mesh program in phase (b): its eager first call, its
#: capture, then replays
MESH_CALLS = 3
#: steps of llama3.2-1b on the (1, 1) mesh in phase (c): eager, capture,
#: replays
MESH_TRAIN_STEPS = 4
#: MoE equality on one rank: the routed output of one full-width
#: deepseek-v2-lite-16b layer, 4096 seeded tokens
MESH_MOE_TOKENS = (2, 2048)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_mesh(dev, llama_losses) -> dict:
    """The mesh slice on one card:
      (a) `Autotuner().tune` of gemma-2b's full-width decode MLP through
          `lower()` over DEFAULT_CANDIDATES, measured: tuned <= default,
          a warm call with no new search, the winners file round-tripped;
      (b) a one-rank NCCL process group and a (1,) "data" mesh:
          `execute_sharded` of the largest access and the MLP through
          `lower(mesh=)` on the paper's array equal to the unsharded
          calls, planes, outputs and ledgers, 81 launches a call;
      (c) on a (1, 1) mesh: llama3.2-1b trained 2 steps at full width
          through the train entry point on DTensor state (losses equal to
          the configs phase's unsharded run), and `moe_apply_ep` of one
          deepseek-v2-lite-16b layer equal to `moe_apply`'s routed output;
      (d) one dry-run cell on a 256-rank fake group, its roofline printed.
    The fused and flash launches of (a)-(c) are counted from 0 each."""
    import torch
    import torch.distributed as dist

    from repro_torch.cim import array, dispatch, fused_kernel
    from repro_torch.cim.accounting import LEDGER
    from repro_torch.cim.autotune import DEFAULT_CANDIDATES, Autotuner
    from repro_torch.cim.lower import lower
    from repro_torch.cim.planepack import PlanePack
    from repro_torch.configs import preset_config
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers, moe, moe_ep

    fused = fused_kernel.fused_planes_op
    out = {"times": {}}
    cfg = preset_config("gemma-2b", "full")
    gen = torch.Generator(device=dev).manual_seed(0)
    act = cfg.activation_dtype()
    p = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gating, act, dev)
    x = torch.randn((2, 1, cfg.d_model), generator=gen, device=dev).to(act)

    def mlp(p_, x_):
        return layers._mlp_quantized(p_, x_, cfg.gating, 8)

    # (a) the autotuner, measured on the card
    t = time.perf_counter()
    tuner = Autotuner()
    fused.launches = 0
    g0 = dispatch.graph_stats()
    # `steady_ms` raises if a timed call runs an eager first call or
    # captures (C1): every measured ms is of replays only
    res = tuner.tune(mlp, (p, x), candidates=DEFAULT_CANDIDATES,
                     measure=True)
    torch.cuda.synchronize()
    g1 = dispatch.graph_stats()
    launches_tune = fused.launches
    assert not res.from_cache and tuner.searches == 1
    assert res.tuned_ms <= res.default_ms, (res.tuned_ms, res.default_ms)
    assert res.tuned_vs_default_walltime_ratio >= 1.0
    warm = tuner.tune(mlp, (p, x), candidates=DEFAULT_CANDIDATES,
                      measure=True)
    assert warm.from_cache and warm.winner == res.winner and \
        tuner.searches == 1
    path = os.path.join(ROOT, "build", "autotune_winners.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tuner.save(path)
    fresh = Autotuner()
    assert fresh.load(path) == 1
    again = fresh.tune(mlp, (p, x), candidates=DEFAULT_CANDIDATES)
    assert again.from_cache and again.winner == res.winner and \
        fresh.searches == 0
    fused.launches = 0
    win = lower(mlp, spec=res.winner.spec(), policy="always")
    y_win = win(p, x)
    torch.cuda.synchronize()
    winner_launches = fused.launches
    assert torch.equal(y_win, mlp(p, x))
    out["autotune"] = {
        "predicted_edp": res.predicted_edp, "measured_ms": res.measured_ms,
        "default_ms": res.default_ms, "tuned_ms": res.tuned_ms,
        "winner": repr(res.winner), "winner_launches": winner_launches,
        "walltime_ratio": res.tuned_vs_default_walltime_ratio,
        "edp_ratio": res.tuned_vs_default_edp_ratio,
        "launches": launches_tune,
        "warmup_graphs": {k: g1[k] - g0[k] for k in g1}}
    out["times"]["autotune"] = time.perf_counter() - t
    for name, edp in res.predicted_edp.items():
        print(f"mesh[autotune]: predicted_edp {edp:.6g} "
              f"measured_ms {res.measured_ms.get(name)} {name}")
    print(f"mesh[autotune]: default_ms {res.default_ms:.3f} tuned_ms "
          f"{res.tuned_ms:.3f} (ratio {res.tuned_vs_default_walltime_ratio:.3f},"
          f" edp ratio {res.tuned_vs_default_edp_ratio:.3f}); winner "
          f"{res.winner!r}, {winner_launches} fused launches a call; "
          f"{launches_tune} launches in the search; warm: 0 new searches; "
          f"winners file round-tripped; {out['times']['autotune']:.1f} s; "
          f"{g1['captured'] - g0['captured']} graphs captured and "
          f"{g1['eager'] - g0['eager']} eager first calls, all in "
          f"warm-up calls: no timed call compiled")

    # (b) a one-rank NCCL group: the tiled access and lower() over a mesh
    t = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=dev)
    try:
        mesh = make_mesh((1,), ("data",), "cuda")
        spec = array.DEFAULT_SPEC
        n_bits, w = 29, (2 * 16384 * 2048) // 32

        def planes():
            return torch.randint(-2 ** 31, 2 ** 31, (n_bits, w),
                                 dtype=torch.int32, device=dev,
                                 generator=gen)
        pa = PlanePack(planes(), n_bits, True, (w * 32,))
        pb = PlanePack(planes(), n_bits, True, (w * 32,))

        def timed(fn):
            """(fn(), its fused launches, its ledger, its wall ms)."""
            LEDGER.reset()
            fused.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            return (r, fused.launches, dataclasses.asdict(LEDGER),
                    (time.perf_counter() - t0) * 1e3)

        def mesh_programs():
            """The stats of every cached program over the mesh."""
            return [dict(prog.stats) for k, prog in dispatch._PROGRAMS.items()
                    if k[-1] is not None]

        def check(label, want, calls, launches):
            """Every call over the mesh equal to the unsharded call: output,
            ledger, `launches` fused launches; every program over the mesh
            captured once and replayed."""
            for i, got in enumerate(calls):
                assert torch.equal(got[0], want[0]), (label, i)
                assert got[2] == want[2], (label, i, got[2], want[2])
                assert got[1] == want[1] == launches, (label, i, got[1])
            stats = mesh_programs()
            assert stats and all(g["captured"] == 1 and g["replays"] >= 1
                                 for g in stats), (label, stats)
            return {"accesses": want[2]["accesses"], "launches": want[1],
                    "ms": [c[3] for c in calls], "unsharded_ms": want[3],
                    "programs": len(stats),
                    "replays": sum(g["replays"] for g in stats),
                    "capture_s": sum(g["capture_s"] for g in stats)}
        # the unsharded call, then MESH_CALLS calls over the mesh: each
        # program's eager first call, its capture, then replays
        dispatch.clear_schedule_cache()
        want = timed(lambda: dispatch.execute_tiled(pa, pb, ("add",),
                                                    spec=spec)["add"].planes)
        calls = [timed(lambda: dispatch.execute_sharded(
            pa, pb, ("add",), mesh, spec=spec)["add"].planes)
            for _ in range(MESH_CALLS)]
        acc = check("access", want, calls, 1)
        del want, calls
        dispatch.clear_schedule_cache()
        want = timed(lambda: lower(mlp, spec=spec, policy="always")(p, x))
        lowered = lower(mlp, spec=spec, policy="always", mesh=mesh)
        calls = [timed(lambda: lowered(p, x)) for _ in range(MESH_CALLS)]
        low = check("mlp", want, calls, 81)
        del want, calls, lowered
        dispatch.clear_schedule_cache()
        out["sharded"] = {"access": acc, "mlp": low}
        out["launches_mesh"] = MESH_CALLS * (acc["launches"]
                                             + low["launches"])
        out["times"]["sharded"] = time.perf_counter() - t
        print(f"mesh[sharded]: execute_sharded of {n_bits} planes x {w} "
              f"columns on a (1,) data mesh, {MESH_CALLS} calls (eager, "
              f"capture, replay): planes and ledger equal to the unsharded "
              f"call ({acc['accesses']} activations, {acc['launches']} "
              f"launch a call), {acc['programs']} program, "
              f"{acc['replays']} replays, {acc['capture_s']:.3f} s "
              f"capturing; ms {[round(v, 3) for v in acc['ms']]} against "
              f"unsharded {acc['unsharded_ms']:.3f}; gemma-2b MLP through "
              f"lower(mesh=): output and ledger equal, {low['accesses']} "
              f"accesses, {low['launches']} launches a call, "
              f"{low['programs']} programs, {low['replays']} replays, "
              f"{low['capture_s']:.3f} s capturing; ms "
              f"{[round(v, 3) for v in low['ms']]} against unsharded "
              f"{low['unsharded_ms']:.3f}; {out['times']['sharded']:.1f} s")

        # (c) llama3.2-1b on DTensor state over a (1, 1) mesh: the step
        # program captured at step 2 with its collectives, then replayed
        t = time.perf_counter()
        del pa, pb
        held = _free(dev)
        assert held < 2 ** 30, f"{held} bytes still allocated"
        argv = with_steps(CONFIG_TRAIN, MESH_TRAIN_STEPS)
        reset_launches()
        trep = train.main(argv)
        launches = read_launches()
        losses = [r["loss"] for r in trep["records"]]
        llama_losses = llama_losses[:MESH_TRAIN_STEPS]
        assert trep["restarts"] == 0 and len(losses) == MESH_TRAIN_STEPS
        assert max(abs(a - b) for a, b in zip(losses, llama_losses)) <= \
            1e-6, (losses, llama_losses)
        assert launches["flash_sm90"] == trep["flash_launches"] == \
            32 * MESH_TRAIN_STEPS, launches
        assert sum(launches.values()) == launches["flash_sm90"], launches
        assert trep["capture_steps"] == [0, 1], trep["capture_steps"]
        g = trep["graphs"]
        # the capture's step replays its graph at once, then 2 more
        assert (g["eager"], g["captured"], g["replays"]) == \
            (1, 1, MESH_TRAIN_STEPS - 1), g
        graphed = train_eager("mesh[train]", argv, lambda: None, trep,
                              launches, dev)
        out["train"] = {"losses": losses, "unsharded": llama_losses,
                        "step_ms": [r["ms"] for r in trep["records"]],
                        "peak_gib": trep["peak_gib"],
                        "flash_launches": launches["flash_sm90"],
                        "graphed": graphed}
        out["times"]["train"] = time.perf_counter() - t
        print(f"mesh[train]: llama3.2-1b on a (1, 1) mesh, DTensor state: "
              f"losses {losses} (unsharded {llama_losses}); step ms "
              f"{[round(r['ms'], 2) for r in trep['records']]} (eager "
              f"programs {[round(v, 2) for v in graphed['eager_step_ms']]}); "
              f"capture steps {trep['capture_steps']}, step graph "
              f"{g['captured']} captured / {g['replays']} replays / "
              f"{g['capture_s']:.3f} s; {launches['flash_sm90']} flash "
              f"launches (32 a step, wgmma/TMA); peak "
              f"{trep['peak_gib']:.2f} GiB (eager programs "
              f"{graphed['eager_peak_gib']:.2f}); "
              f"{out['times']['train']:.1f} s")
        del trep
        _free(dev)

        t = time.perf_counter()
        mcfg = preset_config("deepseek-v2-lite-16b", "full")
        mcfg = dataclasses.replace(
            mcfg, moe=dataclasses.replace(mcfg.moe, n_shared=0))
        mgen = torch.Generator(device=dev).manual_seed(0)
        mp = moe.moe_init(mgen, mcfg, mcfg.activation_dtype(), dev)
        xm = torch.randn(MESH_MOE_TOKENS + (mcfg.d_model,), generator=mgen,
                         device=dev).to(mcfg.activation_dtype())
        mesh2 = make_mesh((1, 1), ("data", "model"), "cuda")
        with torch.no_grad():
            want, _ = moe.moe_apply(mp, mcfg, xm)
            got = moe_ep.moe_apply_ep(mp, mcfg, xm, mesh2)
        moe_err = float((got.float() - want.float()).abs().max())
        assert moe_err <= 1e-6, moe_err
        out["moe"] = {"max_abs_err": moe_err, "bit_equal":
                      bool(torch.equal(got, want)),
                      "tokens": MESH_MOE_TOKENS[0] * MESH_MOE_TOKENS[1]}
        out["times"]["moe"] = time.perf_counter() - t
        print(f"mesh[moe]: moe_apply_ep on a (1, 1) mesh, deepseek-v2-lite-"
              f"16b, {out['moe']['tokens']} tokens: max |diff| {moe_err:.3e} "
              f"against moe_apply (bit-equal {out['moe']['bit_equal']})")
        del mp, xm, want, got
    finally:
        dist.destroy_process_group()
    _free(dev)

    # (d) one dry-run cell on 256 fake ranks
    t = time.perf_counter()
    arch, shape, mesh_name = MESH_DRYRUN
    cell = dryrun.run_cell(arch, shape, mesh_name,
                           os.path.join(ROOT, "build", "dryrun"), force=True)
    assert cell.get("status") == "ok", cell.get("traceback")
    out["dryrun"] = {"roofline": cell["roofline"],
                     "seconds": time.perf_counter() - t,
                     "trace_seconds": cell["compile_seconds"],
                     "memory": cell["memory"],
                     "collectives": cell["collectives"]}
    print(f"mesh[dryrun]: {arch} x {shape} x {mesh_name}: "
          f"{json.dumps(cell['roofline'])}; {out['dryrun']['seconds']:.2f} s")

    t = time.perf_counter()
    out["rank_kernels"] = rank_kernels(dev)
    out["times"]["rank_kernels"] = time.perf_counter() - t
    return out


def rank_kernels(dev) -> dict:
    """The mesh phase's step (e): the RG-LRU and bf16 flash kernels on a
    tensor-parallel rank's blocks against the whole-width call, to the bit
    (channels, and heads with their kv heads, are independent), each block
    on the sm90 kernel, each block's call timed (CUDA events)."""
    import torch

    from repro_torch.kernels import flash_attention as fm
    from repro_torch.kernels import rglru as rg

    gen = torch.Generator(device=dev).manual_seed(5)
    out = {"rglru": {}, "flash": {}}
    shape, splits = MESH_RANK_RGLRU
    d = shape[-1]
    x, r, i = (torch.randn(shape, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    ll = torch.randn((d,), generator=gen, device=dev)
    y, h = rg.rglru(x, r, i, ll)
    whole_ms = cuda_ms(lambda: rg.rglru(x, r, i, ll))
    for m in splits:
        w = d // m
        routes, ms = set(), []
        for k in range(m):
            blk = slice(k * w, (k + 1) * w)
            xb, rb, ib = (a[..., blk].contiguous() for a in (x, r, i))
            lb = ll[blk].contiguous()
            routes.add(rg.route(xb, rb, ib))
            yb, hb = rg.rglru(xb, rb, ib, lb)
            assert torch.equal(yb, y[..., blk]) and \
                torch.equal(hb, h[..., blk]), ("rglru block", m, k)
            ms.append(cuda_ms(lambda: rg.rglru(xb, rb, ib, lb)))
        assert routes == {"sm90"}, routes
        out["rglru"][m] = {"shape": [shape[0], shape[1], w],
                           "block_ms": ms, "whole_ms": whole_ms}
        print(f"mesh[rank kernels]: rglru {shape} over {m} channel blocks "
              f"of {w}: each equal to the whole call's columns, sm90; ms a "
              f"block {min(ms):.4f}-{max(ms):.4f} (whole {whole_ms:.4f})")
    for name, (b, tq, tk, hq, hkv, dd), ranks in MESH_RANK_FLASH:
        q = torch.randn((b, tq, hq, dd), generator=gen, device=dev) \
            .to(torch.bfloat16)
        k, v = (torch.randn((b, tk, hkv, dd), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        o, lse = fm.flash_attention(q, k, v, causal=True)
        whole_ms = cuda_ms(lambda: fm.flash_attention(q, k, v, causal=True))
        group = hq // hkv
        for m in ranks:
            hr = hq // m
            routes, ms = set(), []
            for rank in range(m):
                k0 = rank * hr // group
                k1 = max(k0 + 1, (rank + 1) * hr // group)
                heads = slice(rank * hr, (rank + 1) * hr)
                qb = q[:, :, heads].contiguous()
                kb, vb = (a[:, :, k0:k1].contiguous() for a in (k, v))
                routes.add(fm.route(qb, kb, vb))
                ob, lb = fm.flash_attention(qb, kb, vb, causal=True)
                assert torch.equal(ob, o[:, :, heads]) and \
                    torch.equal(lb, lse[:, heads]), ("flash block", name, m)
                ms.append(cuda_ms(
                    lambda: fm.flash_attention(qb, kb, vb, causal=True)))
            assert routes == {"sm90"}, routes
            out["flash"][f"{name} / {m}"] = {
                "q_heads": hr, "kv_heads": k1 - k0, "block_ms": ms,
                "whole_ms": whole_ms}
            print(f"mesh[rank kernels]: flash {name} {(b, tq, tk, hq, hkv, dd)}"
                  f" over {m} ranks ({hr} q heads, {k1 - k0} kv heads a "
                  f"rank): o and lse equal to the whole call's heads, sm90; "
                  f"ms a block {min(ms):.4f}-{max(ms):.4f} (whole "
                  f"{whole_ms:.4f})")
    return out


#: `--tp-cards`: the sharded train step on (1, n) meshes of n cards (one
#: process a card, NCCL), held to the same step on one card: (arch, layers
#: or None for all, the train entry point's arguments, compute dtype)
TP_CARDS = (2, 4)
TP_STEPS = 4
TP_TRAIN = [("llama3.2-1b", None, with_steps(CONFIG_TRAIN[2:], TP_STEPS),
             "float32"),
            ("llama3.2-1b", None, with_steps(CONFIG_TRAIN[2:], TP_STEPS),
             "bfloat16"),
            ("recurrentgemma-9b", 3,
             with_steps(CONFIG_RECURRENT_ARGS, TP_STEPS), "bfloat16")]
#: how far the float32 sharded losses of the first TP_HELD_STEPS steps may
#: be from the one-card losses: the partial sums over "model" reorder
#: float32 additions. AdamW carries the reordered roundings into the
#: weights, so later steps drift further (2.575e-05 at step 4 on 2 and 4
#: H100s, eager and graphed alike) and are reported, not bounded. In
#: bfloat16 the reordered sums also flip bfloat16 roundings of the
#: activations, so the bfloat16 steps' differences are reported, not
#: bounded (1.4e-5-2.9e-5 at reduced width on CPU ranks, against 4.8e-7
#: in float32)
TP_LOSS_ATOL = 1e-5
TP_HELD_STEPS = 2


def _tp_train(arch: str, layers, argv, dtype: str, dev,
              preset: str) -> dict:
    """`train.main` of `arch` (cut to `layers`, computing in `dtype`) from
    seed 0's weights, the launches and tensor-parallel regions it ran. On
    a card of this port the step program is captured at step 2 (with its
    collectives on a mesh) and replayed, and the same steps are run again
    under `dispatch.eager_programs()` from the same weights: losses, grad
    norms, lrs and every kernel's launches equal to the bit. With `--src`
    (another port) the run is timed as it is."""
    import torch.distributed as dist

    from repro_torch.cim import dispatch
    from repro_torch.configs import preset_config
    from repro_torch.launch import train
    from repro_torch.models.model import build
    from repro_torch.sharding import rules

    cfg = dataclasses.replace(preset_config(arch, preset), dtype=dtype)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    argv = ["--arch", arch] + list(argv)
    argv[argv.index("--preset") + 1] = preset
    argv[argv.index("--device") + 1] = dev.type
    regions = [0]
    exit_ = rules.tp_exit

    def counted(y, mesh):
        regions[0] += 1
        return exit_(y, mesh)

    def run():
        reset_launches()
        regions[0] = 0
        rules.tp_exit = counted
        try:
            rep = train.main(argv, model=build(cfg, device=dev, seed=0))
        finally:
            rules.tp_exit = exit_
        if dev.type == "cuda":
            _free(dev)
        return rep, read_launches(), regions[0]
    rep, launches, n_regions = run()
    steps = len(rep["records"])
    # a replay runs no Python: regions are counted on the steps that ran
    # the body (the eager first call, the capture)
    g = rep.get("graphs")
    ran = steps - g["replays"] + g["captured"] if g else steps
    out = {"losses": [r["loss"] for r in rep["records"]],
           "step_ms": [r["ms"] for r in rep["records"]],
           "peak_gib": rep["peak_gib"], "flash": rep["flash_launches"],
           "rglru": rep["rglru_launches"],
           "regions_per_step": n_regions / ran,
           "graphs": rep.get("graphs"),
           "capture_steps": rep.get("capture_steps"),
           "ranks": dist.get_world_size() if dist.is_initialized() else 1}
    if "--src" in sys.argv[1:] or dev.type != "cuda":
        return out
    # eager first step, the capture (its graph replayed at once), replays
    assert (g["eager"], g["captured"], g["replays"]) == (1, 1, steps - 1), \
        (arch, dtype, g)
    assert rep["capture_steps"] == [0, 1], rep["capture_steps"]
    with dispatch.eager_programs():
        eager, eager_launches, eager_regions = run()
    for k in ("loss", "grad_norm", "lr"):
        got = [r[k] for r in rep["records"]]
        want = [r[k] for r in eager["records"]]
        assert got == want, (arch, dtype, k, got, want)
    assert launches == eager_launches, (arch, dtype, launches,
                                        eager_launches)
    assert eager_regions / steps == out["regions_per_step"], \
        (n_regions, eager_regions)
    assert eager["graphs"]["captured"] == 0
    out.update(eager_step_ms=[r["ms"] for r in eager["records"]],
               eager_peak_gib=eager["peak_gib"])
    return out


def _tp_rank(rank: int, n: int, port: int, device_type: str, preset: str,
             out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    dev = torch.device(device_type, rank) if device_type == "cuda" else \
        torch.device("cpu")
    kw = {}
    if device_type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # the communicators made now, before any step's capture
        kw["device_id"] = dev
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=n, **kw)
    try:
        res = {f"{arch} {dtype}": _tp_train(arch, layers, argv, dtype, dev,
                                            preset)
               for arch, layers, argv, dtype in TP_TRAIN}
        if rank == 0:
            with open(os.path.join(out_dir, f"tp_{n}.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _tp_line(label: str, r: dict) -> str:
    """One run's step ms, graphs, eager step ms and peak."""
    g = r["graphs"]
    graphs = (f"step graph {g['captured']} captured / {g['replays']} "
              f"replays / {g['capture_s']:.3f} s" if g else "no step graph")
    eager = (f" (eager programs {[round(x, 2) for x in r['eager_step_ms']]},"
             f" peak {r['eager_peak_gib']} GiB; losses, grad norms, lrs and "
             f"launches equal to the bit)" if "eager_step_ms" in r else "")
    return (f"{label}: {graphs}; capture steps {r['capture_steps']}; step ms "
            f"{[round(x, 2) for x in r['step_ms']]}, peak {r['peak_gib']} "
            f"GiB{eager}")


def phase_tp_cards(device_type: str = "cuda", preset: str = "full",
                   cards=TP_CARDS) -> dict:
    """The sharded train step across cards (`--tp-cards`): TP_TRAIN on
    one device, then on (1, n) meshes of n processes, one card each
    (NCCL; gloo with `device_type="cpu"`, a CPU rehearsal at `preset`
    "reduced"): the whole step tensor-parallel over "model", each rank's
    step program captured with its collectives at step 2 and replayed,
    equal to the bit to the same steps under `eager_programs()`, float32
    losses of the first TP_HELD_STEPS steps within TP_LOSS_ATOL of the
    one-device losses and every other difference reported, the
    tensor-parallel regions a step, the
    flash and RG-LRU launches of each rank, its step ms and its peak
    device memory."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    dev = torch.device(device_type, 0) if device_type == "cuda" else \
        torch.device("cpu")
    one = {}
    for arch, layers, argv, dtype in TP_TRAIN:
        one[f"{arch} {dtype}"] = r = _tp_train(arch, layers, argv, dtype,
                                               dev, preset)
        print(_tp_line(f"tp[1 card]: {arch} {dtype}", r), flush=True)
    out = {"one": one, "src": SRC}
    work = tempfile.mkdtemp()
    diffs = {}
    for n in cards:
        t = time.perf_counter()
        mp.spawn(_tp_rank, args=(n, _free_port(), device_type, preset, work),
                 nprocs=n)
        with open(os.path.join(work, f"tp_{n}.json")) as f:
            res = json.load(f)
        for arch, r in res.items():
            diffs_ = [abs(a - b) for a, b in
                      zip(r["losses"], one[arch]["losses"])]
            diff = max(diffs_[:TP_HELD_STEPS])
            r["max_loss_diff"] = diff
            r["max_loss_diff_all"] = max(diffs_)
            print(f"tp[{n} cards]: {arch}: losses {r['losses']} (one card "
                  f"{one[arch]['losses']}, max |diff| {diff:.3e} over the "
                  f"first {TP_HELD_STEPS} steps, {max(diffs_):.3e} over "
                  f"all); "
                  f"{r['regions_per_step']:g} tensor-parallel regions a step;"
                  f" rank 0: {r['flash']} flash, {r['rglru']} rglru "
                  f"launches", flush=True)
            print(_tp_line(f"tp[{n} cards]: {arch} rank 0", r), flush=True)
            diffs[(n, arch)] = diff
        out[n] = res
        out[f"{n}_s"] = time.perf_counter() - t
    f32 = {k: d for k, d in diffs.items() if k[1].endswith("float32")}
    assert max(f32.values()) <= TP_LOSS_ATOL, diffs
    return out


def phase_mesh_cells(dev) -> dict:
    """`--mesh-cells`: the timings of the mesh programs on one card, on
    this port or another (`--src`), without the checks of phase 10: on a
    one-rank NCCL group, MESH_CALLS calls of `execute_sharded` of the
    largest access and of gemma-2b's decode MLP through `lower(mesh=)`
    (wall ms each), then MESH_TRAIN_STEPS steps of llama3.2-1b on a (1, 1)
    mesh (step ms, capture steps, graphs, peak)."""
    import torch
    import torch.distributed as dist

    from repro_torch.cim import array, dispatch
    from repro_torch.cim.lower import lower
    from repro_torch.cim.planepack import PlanePack
    from repro_torch.configs import preset_config
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers

    out = {"src": SRC}
    cfg = preset_config("gemma-2b", "full")
    gen = torch.Generator(device=dev).manual_seed(0)
    act = cfg.activation_dtype()
    p = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gating, act, dev)
    x = torch.randn((2, 1, cfg.d_model), generator=gen, device=dev).to(act)
    n_bits, w = 29, (2 * 16384 * 2048) // 32
    pa, pb = (PlanePack(torch.randint(
        -2 ** 31, 2 ** 31, (n_bits, w), dtype=torch.int32, device=dev,
        generator=gen), n_bits, True, (w * 32,)) for _ in range(2))

    def ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=dev)
    try:
        mesh = make_mesh((1,), ("data",), "cuda")
        spec = array.DEFAULT_SPEC
        dispatch.clear_schedule_cache()
        out["access_ms"] = [ms(lambda: dispatch.execute_sharded(
            pa, pb, ("add",), mesh, spec=spec)) for _ in range(MESH_CALLS)]
        dispatch.clear_schedule_cache()
        lowered = lower(lambda p_, x_: layers._mlp_quantized(
            p_, x_, cfg.gating, 8), spec=spec, policy="always", mesh=mesh)
        out["mlp_ms"] = [ms(lambda: lowered(p, x))
                         for _ in range(MESH_CALLS)]
        out["graph_stats"] = dispatch.graph_stats()
        del lowered, pa, pb, p, x
        dispatch.clear_schedule_cache()
        _free(dev)
        rep = train.main(with_steps(CONFIG_TRAIN, MESH_TRAIN_STEPS))
        out["train"] = {"step_ms": [r["ms"] for r in rep["records"]],
                        "losses": [r["loss"] for r in rep["records"]],
                        "capture_steps": rep.get("capture_steps"),
                        "graphs": rep.get("graphs"),
                        "peak_gib": rep["peak_gib"]}
    finally:
        dist.destroy_process_group()
    print(f"mesh-cells[{SRC}]: execute_sharded ms "
          f"{[round(v, 3) for v in out['access_ms']]}; lower(mesh=) MLP ms "
          f"{[round(v, 3) for v in out['mlp_ms']]}; llama3.2-1b (1, 1) "
          f"step ms {[round(v, 2) for v in out['train']['step_ms']]}, "
          f"capture steps {out['train']['capture_steps']}, graphs "
          f"{out['train']['graphs']}, peak {out['train']['peak_gib']:.2f} "
          f"GiB", flush=True)
    return out


#: `--cells`: the float serve cells (xlstm-125m, the four float configs,
#: the hybrid's 2040-token prefill) and train cells (gemma-2b,
#: llama3.2-1b, xlstm-125m, the 3-layer hybrid) at this file's lengths,
#: then deepseek-v2-lite-16b's CiM serve and the autotuner
CELLS_SERVE = [("xlstm-125m", XLSTM_SERVE)] + [
    (a, ["--arch", a, "--preset", "full", "--device", "cuda", "--slots",
         "2", "--prompt-len", "8"] + CONFIG_FLOAT_ARGS)
    for a in CONFIG_FLOAT] + [("recurrentgemma-9b prefill", HYBRID_PREFILL)]


def _serve_cell(rep: dict) -> dict:
    """A serve report's timings (keys a port without step graphs lacks are
    None)."""
    out = {k: rep.get(k) for k in (
        "p50_ms", "p99_ms", "tok_s_steady", "prefill_ms_mean",
        "prefill_ms_replay_mean", "decode_steps", "capture_steps",
        "capture_step_ms", "graphs", "step_graphs")}
    out["prefill_ms"] = [r["prefill_ms"] for r in rep["per_request"]]
    out["prefill_kinds"] = [r.get("prefill_kind")
                            for r in rep["per_request"]]
    out["tokens"] = [r["token_ids"] for r in rep["per_request"]]
    return out


def phase_cells(dev) -> dict:
    """The cells alone, through the entry points, one model on the card at
    a time, each with its peak device memory; on whatever port `SRC`
    holds, so only the entry points' reports are read."""
    import torch
    from repro_torch.cim import dispatch
    from repro_torch.cim.autotune import DEFAULT_CANDIDATES, Autotuner
    from repro_torch.configs import preset_config
    from repro_torch.launch import serve, train
    from repro_torch.models import layers

    torch.empty(0, device=dev)      # a context before the first reading
    out = {"src": SRC, "serve": {}, "train": {}}
    for name, argv in CELLS_SERVE:
        assert _free(dev) < 2 ** 30, name
        torch.cuda.reset_peak_memory_stats(dev)
        serve.fresh_cim_state()
        t = time.perf_counter()
        rep = serve.main(argv)
        cell = _serve_cell(rep)
        cell["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        cell["s"] = time.perf_counter() - t
        out["serve"][name] = cell
        print(f"cells[{name}]: p50 {cell['p50_ms']:.3f} ms, p99 "
              f"{cell['p99_ms']:.3f} ms, {cell['tok_s_steady']:.4f} tok/s, "
              f"prefill ms {cell['prefill_ms']} ({cell['prefill_kinds']}), "
              f"capture steps {cell['capture_steps']}, peak "
              f"{cell['peak_gib']:.2f} GiB", flush=True)
        del rep
    trains = [("gemma-2b", TRAIN, None), ("llama3.2-1b", CONFIG_TRAIN, None)]
    trains += [(a, ["--arch", a] + CONFIG_RECURRENT_ARGS, layers_)
               for a, layers_ in CONFIG_RECURRENT_TRAIN.items()]
    for arch, argv, n_layers in trains:
        assert _free(dev) < 2 ** 30, arch
        targs = train.parse_args(argv)
        cfg = preset_config(arch, targs.preset)
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        from repro_torch.models.model import build
        t = time.perf_counter()
        rep = train.main(argv, model=build(cfg, device=dev, seed=0))
        cell = {"step_ms": [r["ms"] for r in rep["records"]],
                "losses": [r["loss"] for r in rep["records"]],
                "tok_s_steady": rep["tok_s_steady"],
                "capture_steps": rep.get("capture_steps"),
                "graphs": rep.get("graphs"), "peak_gib": rep["peak_gib"],
                "s": time.perf_counter() - t}
        out["train"][arch] = cell
        print(f"cells[{arch} train]: step ms "
              f"{[round(x, 2) for x in cell['step_ms']]}, "
              f"{cell['tok_s_steady']:.2f} tokens/s, capture steps "
              f"{cell['capture_steps']}, peak {cell['peak_gib']:.2f} GiB",
              flush=True)
        del rep
    assert _free(dev) < 2 ** 30
    serve.fresh_cim_state()
    rep = serve.main(["--arch", "deepseek-v2-lite-16b"] + SERVE
                     + CONFIG_SERVE_ARGS)
    out["deepseek"] = {k: _serve_cell(r) for k, r in rep["phases"].items()}
    print("cells[deepseek-v2-lite-16b]: p50 " + ", ".join(
        f"{k} {c['p50_ms']:.2f} ms (capture steps {c['capture_steps']})"
        for k, c in out["deepseek"].items()), flush=True)
    del rep
    serve.fresh_cim_state()
    assert _free(dev) < 2 ** 30
    cfg = preset_config("gemma-2b", "full")
    gen = torch.Generator(device=dev).manual_seed(0)
    act = cfg.activation_dtype()
    p = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gating, act, dev)
    x = torch.randn((2, 1, cfg.d_model), generator=gen, device=dev).to(act)

    def mlp(p_, x_):
        return layers._mlp_quantized(p_, x_, cfg.gating, 8)
    res = Autotuner().tune(mlp, (p, x), candidates=DEFAULT_CANDIDATES,
                           measure=True)
    out["autotune"] = {"measured_ms": {repr(c): ms for c, ms in
                                       res.measured_ms.items()},
                       "default_ms": res.default_ms,
                       "tuned_ms": res.tuned_ms, "winner": repr(res.winner),
                       "graphs": dispatch.graph_stats()}
    print(f"cells[autotune]: measured ms "
          f"{sorted(out['autotune']['measured_ms'].values())}, default "
          f"{res.default_ms:.3f}, tuned {res.tuned_ms:.3f}, winner "
          f"{res.winner!r}", flush=True)
    serve.fresh_cim_state()
    return out


def phase_profile(m, dev, max_len: int, position: int) -> None:
    """One decode step at 2 slots under torch.profiler (after two warm-up
    steps: the first pins a resident model's weights and runs each program
    eagerly, the second captures the programs as CUDA graphs, so the
    profiled step replays them): device time by PyTorch op and by ported
    kernel, the device's idle share, the fused kernel's rows in the trace
    against its counted launches, and the peak device memory from the
    warm-up on."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.cim import fused_kernel
    from repro_torch.launch import serve

    caches = m.init_caches(2, max_len)
    step = {"tokens": torch.tensor([[1], [2]], device=dev),
            "positions": torch.tensor([position, position], dtype=torch.int32,
                                      device=dev)}
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(2):
        m.decode_step(caches, step)
    torch.cuda.synchronize()
    fused = fused_kernel.fused_planes_op
    launches0, bytes0 = fused.launches, fused.bytes
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        m.decode_step(caches, step)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    fused_launches = fused.launches - launches0
    fused_bytes = fused.bytes - bytes0
    # key_averages() holds each kernel twice, as its own device row and in
    # the self device time of the PyTorch op that launched it; busy time
    # sums the device rows only (the ctypes kernels have no op above them),
    # and not the device-side copies of the port's `repro.` spans
    events = prof.key_averages()
    kernels = [(e.key, e.count, e.self_device_time_total / 1e3)
               for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    ops = [(e.key, e.count, e.self_device_time_total / 1e3)
           for e in events if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    busy_ms = sum(r[2] for r in kernels)
    custom = [r for r in kernels
              if any(k in r[0] for k in (
                  "fused_planes_kernel", "rglru_kernel", "rglru_tile_kernel",
                  "slstm_kernel", "slstm_grid_kernel"))]
    print(f"profile[{m.cfg.name}]: decode step wall {wall_ms:.2f} ms, "
          f"device busy {busy_ms:.2f} ms (idle share "
          f"{1 - busy_ms / wall_ms:.3f}), peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    if fused_launches:
        # kernels replayed from a CUDA graph should still be traced one by
        # one; where they are not, the programs' recorded counts stand
        rows = sum(r[1] for r in kernels if "fused_planes_kernel" in r[0])
        print(f"profile[{m.cfg.name}]: fused kernel rows in the trace "
              f"{rows}, counted launches {fused_launches}"
              + ("" if rows == fused_launches else
                 " (the trace misses graph-replayed kernels: the count is "
                 "the programs' recorded launches)"))
        # each launch's bytes (both stacks read, every output plane written)
        # over the memory rate, summed over the step
        fused_ms = sum(r[2] for r in kernels if "fused_planes_kernel" in r[0])
        bound_ms = fused_bytes / HBM_BYTES_PER_S * 1e3
        share = f"{bound_ms / fused_ms:.3f}" if fused_ms else "not measured"
        print(f"profile[{m.cfg.name}]: fused kernel {fused_ms:.2f} ms for "
              f"{fused_launches} launches against a summed byte bound of "
              f"{bound_ms:.2f} ms ({fused_bytes} B; {share}"
              f" of the bound's speed)")
    for name, count, ms in sorted(custom + ops, key=lambda r: -r[2])[:12]:
        print(f"profile:   {ms:10.3f} ms  x{count:<6d} {name[:90]}")
    serve.fresh_cim_state()


def main() -> int:
    # the hybrid serve runs within a few GB of the card's 80; growable
    # segments keep the caching allocator's freed blocks usable by the
    # next, differently sized prefill allocation instead of stranding them
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from repro_torch import kernel_build
    from repro_torch.cim import fused_kernel
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import rglru as rglru_mod
    from repro_torch.kernels import slstm as slstm_mod

    profile = "--profile" in sys.argv[1:]
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--cells" in sys.argv[1:]:
        t = time.perf_counter()
        sources = (fused_kernel.SOURCE, rglru_mod.SOURCE_SM90,
                   rglru_mod.SOURCE, slstm_mod.SOURCE_SM90, slstm_mod.SOURCE,
                   flash_mod.SOURCE, flash_mod.SOURCE_SM90)
        kernel_build.compile_all(sources)
        print(f"gpu: {smi_line()}")
        cells = phase_cells(dev)
        cells["s"] = time.perf_counter() - t
        print("cells: " + json.dumps(cells))
        print(f"gpu: {smi_line()}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--mesh-cells" in sys.argv[1:]:
        kernel_build.compile_all((fused_kernel.SOURCE, flash_mod.SOURCE,
                                  flash_mod.SOURCE_SM90))
        print(f"gpu: {smi_line()}")
        cells = phase_mesh_cells(dev)
        print("mesh-cells: " + json.dumps(cells))
        print(f"gpu: {smi_line()}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--tp-cards" in sys.argv[1:]:
        print(f"gpu: {smi_line()}")
        tp = phase_tp_cards()
        print("tp: " + json.dumps(tp))
        print(f"gpu: {smi_line()}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    phases = {}

    t = time.perf_counter()
    sources = (fused_kernel.SOURCE, rglru_mod.SOURCE_SM90, rglru_mod.SOURCE,
               slstm_mod.SOURCE_SM90, slstm_mod.SOURCE, flash_mod.SOURCE,
               flash_mod.SOURCE_SM90)
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
    # the first GPU's maximum SM clock, for the RG-LRU's SFU bound
    sm_mhz = float(smi_line("clocks.max.sm").splitlines()[0].split()[0])
    print(f"gpu: clocks.max.sm {sm_mhz:g} MHz")

    t = time.perf_counter()
    kern = phase_kernel(dev)
    phases["kernel_s"] = time.perf_counter() - t
    t = time.perf_counter()
    banked = phase_banked(dev)
    phases["banked_s"] = time.perf_counter() - t
    t = time.perf_counter()
    low = phase_lower(dev)
    phases["lower_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ana = phase_analog(dev)
    phases["analog_s"] = time.perf_counter() - t
    t = time.perf_counter()
    rg = phase_rglru(dev, sm_mhz)
    phases["rglru_s"] = time.perf_counter() - t
    t = time.perf_counter()
    sl = phase_slstm(dev)
    phases["slstm_s"] = time.perf_counter() - t
    t = time.perf_counter()
    fl = phase_flash(dev)
    phases["flash_s"] = time.perf_counter() - t

    runs = {}
    for arch in PATHS:
        t = time.perf_counter()
        runs[arch] = phase_serve(arch, dev, profile)
        phases[f"{arch}_s"] = time.perf_counter() - t
        for k, v in runs[arch]["times"].items():
            phases[f"{arch}_{k}"] = v
        model = runs[arch].pop("model")
        if arch == "gemma-2b":
            t = time.perf_counter()
            graph_step = phase_graph_step(model, dev)
            phases["graph_step_s"] = time.perf_counter() - t
            t = time.perf_counter()
            adra = phase_adra_faults(model, dev)
            phases["adra_faults_s"] = time.perf_counter() - t
        if arch == "recurrentgemma-9b":
            t = time.perf_counter()
            pre = phase_hybrid_prefill(model, dev)
            phases["hybrid_prefill_s"] = time.perf_counter() - t
        del model
        gc.collect()
        torch.cuda.empty_cache()
    assert sum(runs["gemma-2b"]["rglru_launches"].values()) == 0
    t = time.perf_counter()
    xl = phase_xlstm(dev, profile)
    phases["xlstm-125m_s"] = time.perf_counter() - t
    for k, v in xl["times"].items():
        phases[f"xlstm-125m_{k}"] = v
    t = time.perf_counter()
    agree = phase_agree(dev)
    phases["agree_s"] = time.perf_counter() - t
    t = time.perf_counter()
    tr = phase_train(dev, profile)
    phases["train_s"] = time.perf_counter() - t
    t = time.perf_counter()
    tra = phase_train_agree(dev)
    phases["train_agree_s"] = time.perf_counter() - t
    t = time.perf_counter()
    conf = phase_configs(dev, profile)
    phases["configs_s"] = time.perf_counter() - t
    for k, v in conf["times"].items():
        phases[f"configs_{k}"] = v
    t = time.perf_counter()
    mesh = phase_mesh(dev, conf["train"]["losses"])
    phases["mesh_s"] = time.perf_counter() - t
    for k, v in mesh["times"].items():
        phases[f"mesh_{k}"] = v

    print("phases: " + json.dumps({k: round(v, 3) for k, v in phases.items()}))
    fused = {"name": "fused_planes", "route": "cuda",
             "source": "src/repro_torch/cim/csrc/fused_planes.cu",
             "replaces": "src/repro/cim/fused_kernel.py:137",
             "launches": sum(r["fused_launches"] for r in runs.values())
             + banked["launches"] + low["launches"] + adra["launches"]
             + ana["launches"] + conf["fused_launches"]
             + mesh["launches_mesh"] + mesh["autotune"]["launches"],
             "launches_banked": banked["launches"],
             "launches_mesh": mesh["launches_mesh"],
             "launches_autotune": mesh["autotune"]["launches"],
             "launches_lower": low["launches"],
             "launches_analog": ana["launches"],
             "launches_adra_faults": adra["launches"],
             "launches_serve": {a: r["fused_launches"]
                                for a, r in runs.items()},
             "launches_configs": {a: r["fused_launches"] for a, r in
                                  conf["serve"].items()
                                  if "fused_launches" in r},
             "max_abs_err": kern["max_abs_err"],
             "ms": kern["ms"], "plain_ms": kern["plain_ms"],
             "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
             "library_ms": None, "banked": {k: banked[k] for k in (
                 "timing", "cap", "cases", "mlp_s")},
             "lower": {k: low[k] for k in ("cases", "plan_stats")},
             "adra_faults": {k: adra[k] for k in (
                 "paper", "sampler", "chaos", "failover")},
             "analog": {k: ana[k] for k in (
                 "full_width", "mlp", "tiled", "analyze")},
             "autotune": mesh["autotune"], "sharded": mesh["sharded"],
             "moe_ep": mesh["moe"]}
    # the main path's RG-LRU launches: the hybrid's CiM serve, its float
    # prefill phase and the configs phase's training, per kernel
    rec_launches = {k: runs["recurrentgemma-9b"]["rglru_launches"][k]
                    + pre["launches"][k]
                    + conf["recurrent_launches"][f"rglru_{k}"]
                    for k in ("sm90", "rows")}
    rec = {"name": "rglru", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/rglru_sm90.cu",
           "replaces": "src/repro/kernels/rglru.py:79",
           "variant": "sm90: C-channel tiles of one batch row per block, "
                      "TMA ring of x, r, i time tiles, gate warps, one scan "
                      "warp; T < 8 (decode) and TMA-unaddressable D on the "
                      "one-thread-per-channel kernel",
           "rows_source": "src/repro_torch/kernels/csrc/rglru.cu",
           "launches": sum(rec_launches.values()),
           "launches_sm90": rec_launches["sm90"],
           "launches_rows": rec_launches["rows"],
           "launches_serve": sum(runs["recurrentgemma-9b"]
                                 ["rglru_launches"].values()),
           "launches_hybrid_prefill": sum(pre["launches"].values()),
           "launches_train": conf["recurrent_launches"]["rglru_sm90"]
           + conf["recurrent_launches"]["rglru_rows"],
           "max_abs_err": rg["max_abs_err"],
           "max_abs_err_rows": rg["max_abs_err_rows"],
           "ms": rg["ms"], "call_ms": rg["call_ms"],
           "plain_ms": rg["plain_ms"],
           "bound_ms": rg["bound_ms"], "bound_by": rg["bound_by"],
           "library_ms": None, "shape": rg["shape"], "dtype": "bfloat16",
           "cases": rg["cases"], "routed": rg["routed"],
           "timings": rg["timings"], "sweep": rg["sweep"],
           "t_sweep": rg["t_sweep"],
           "hybrid_prefill": {k: pre[k] for k in (
               "prefill_ms", "prefill_ms_mean", "tok_s_steady", "peak_gib",
               "profiled_wall_ms", "profiled_rglru_ms", "prefill_turns_ms",
               "prefill_gain_ms")}}
    slstm_train = {k: conf["recurrent_launches"][f"slstm_{k}"]
                   for k in ("sm90", "rows")}
    cell = {"name": "slstm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/slstm_sm90.cu",
            "replaces": "src/repro/kernels/slstm.py:97",
            "variant": "sm90: persistent cooperative grid, R slices in "
                       "shared memory, one grid barrier a step; wider D and "
                       "B > 32 on the one-block-per-row kernel",
            "rows_source": "src/repro_torch/kernels/csrc/slstm.cu",
            "launches": xl["slstm_launches"] + slstm_train["sm90"]
            + slstm_train["rows"],
            "launches_sm90": xl["sm90_launches"] + slstm_train["sm90"],
            "launches_rows": xl["slstm_launches"] - xl["sm90_launches"]
            + slstm_train["rows"],
            "launches_serve": xl["slstm_launches"],
            "launches_train": slstm_train["sm90"] + slstm_train["rows"],
            "max_abs_err": sl["max_abs_err"],
            "ms": sl["ms"], "ms_again": sl["ms_again"],
            "plain_ms": sl["plain_ms"],
            "bound_ms": sl["bound_ms"], "bound_by": sl["bound_by"],
            "library_ms": None, "device_ms": sl["device_ms"],
            "rows_ms": sl["rows_ms"], "rows_device_ms": sl["rows_device_ms"],
            "shape": sl["shape"], "long": sl["long"], "cases": sl["cases"],
            "routed": sl["routed"], "grid_sweep": sl["grid_sweep_ms"],
            "xlstm_prefill_ms": xl["prefill_ms"],
            "xlstm_tok_s_steady": xl["tok_s_steady"],
            "agree_max_logit_diff": agree["max_logit_diff"]}
    flash = {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
             "replaces": "src/repro/kernels/flash_attention.py:111",
             "variant": "sm90: TMA + wgmma, bf16, 2 warpgroups per q tile; "
                        "float32 and other bf16 calls on the SIMT kernel",
             "simt_source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "simt_bf16_ms": fl["simt_bf16_ms"],
             "max_abs_err_simt_f32": fl["max_abs_err_simt_f32"],
             "max_abs_err_simt_bf16": fl["max_abs_err_simt_bf16"],
             "o_rel_l2": fl["o_rel_l2"], "o_rel_l2_simt": fl["o_rel_l2_simt"],
             "ms_again": fl["ms_again"],
             "launches": tr["flash_launches"] + conf["flash_launches"]
             + mesh["train"]["flash_launches"],
             "launches_gemma_train": tr["flash_launches"],
             "launches_llama_train": conf["flash_launches"],
             "launches_mesh": mesh["train"]["flash_launches"],
             "launches_sm90": tr["sm90_launches"] + conf["flash_launches"]
             + mesh["train"]["flash_launches"],
             "launches_simt": tr["simt_launches"],
             "max_abs_err": fl["max_abs_err"],
             "ms": fl["ms"], "plain_ms": fl["plain_ms"],
             "bound_ms": fl["bound_ms"], "bound_by": fl["bound_by"],
             "library_ms": fl["library_ms"], "shape": fl["shape"],
             "dtype": "bfloat16",
             "float32": fl["float32"], "llama_train": fl["llama_train"],
             "launches_per_step": tr["per_step"],
             "train_agree": tra, "mesh_train": mesh["train"]}
    print("graphs: " + json.dumps({
        "serve": {a: r["graphs"] for a, r in runs.items()},
        "configs": conf["graphs"],
        "gemma_step": graph_step}))
    # the float paths' step programs: serve (prefill, decode, insert) and
    # train (the whole step), each against its eager run
    print("step_graphs: " + json.dumps({
        "xlstm-125m": xl["graphed"], "hybrid_prefill": pre["graphed"],
        "float_configs": conf["float_graphs"],
        "train_gemma-2b": tr["graphed"],
        "train_llama3.2-1b": conf["train"]["graphed"],
        **{f"train_{a}": r["graphed"]
           for a, r in conf["recurrent_train"].items()}}))
    print("mesh: " + json.dumps({k: mesh[k] for k in (
        "sharded", "train", "moe", "dryrun", "rank_kernels")}))
    print("configs: " + json.dumps({k: conf[k] for k in (
        "peak_gib", "serve", "train", "agree", "recurrent_train",
        "recurrent_agree")}))
    print(json.dumps({"kernels": [fused, rec, cell, flash]}))
    print(f"gpu: {smi_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
