"""Continuous-batching serve engine over the CiM-quantized model.

Port of `repro.launch.serve`. It serves every family of the registry:
dense (gemma-2b, llama3.2-1b, qwen3-14b, granite-3-8b), MoE with MLA
(deepseek-v2-lite-16b: only its dense layer 0's MLP lowers to CiM; the MoE
layers and MLA run in float, as in the reference), embed stub
(musicgen-large, internvl2-26b: seeded pseudo-embeddings stand in for the
frontend, 0.02 x normal as the reference draws them), the hybrid
(recurrentgemma-9b: RG-LRU recurrent blocks, each launching the RG-LRU
kernel on the card, and sliding-window local attention, both float, with
int8 CiM MLPs in every layer) and the ssm one (xlstm-125m: mLSTM blocks in
plain PyTorch and sLSTM blocks, each launching the sLSTM kernel on the
card, on the float path only). The model it builds holds its cast layer
weights in the compute dtype only (`build(..., for_serving=True)`). For
example:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --preset full --device cuda --slots 2 --requests 4 --prompt-len 8 \
      --gen 8 --cim-lower --cim-resident --assert-warm
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch recurrentgemma-9b --preset full --device cuda --slots 2 \
      --requests 2 --prompt-len 8 --gen 6 --cim-lower --cim-resident \
      --assert-warm
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \
      --preset full --device cuda --slots 2 --requests 4 --prompt-len 512 \
      --gen 16
  REPRO_CIM_FAULT_SEED=0 REPRO_CIM_FAULT_RESIDENT_BER=1e-9 \
      PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --preset full --device cuda --slots 2 --requests 2 --prompt-len 8 \
      --gen 4 --cim-lower --cim-resident --sampler adra --cim-faults \
      --scrub-every 2

xLSTM layers hold no MLP and no global attention, so nothing in them
lowers to CiM: with --cim-lower an xLSTM run charges nothing and fails the
resident-vs-repack assertion below, as the reference's does.

The engine holds `slots` concurrent sequences in one batched KV cache. Each
loop iteration admits at most one due request (a batch-1 prefill inserted
into its slot between decode steps) and then runs ONE full-batch decode
step for every in-flight sequence; retired sequences free their slot and
their paged KV blocks at once. `--sampler adra` picks each token with the
ADRA tournament (`repro_torch.train.adra_sample`: ceil(log2 V) lowered
accesses per sampled batch, on the fused kernel) instead of argmax.

Self-healing: an installed fault model (`repro_torch.cim.faults`) is
advanced to each decode step; a bank it kills is failed over (degraded
spec, paged KV migrated, stale pins dropped and re-pinned, the process
spec override installed). A decode step whose ECC verify finds damage
SECDED cannot repair is retried within `retry_budget` (the failing pin is
already invalidated, so the retry re-pins it); `scrub_every` decode steps
a scrub pass repairs every protected pin. Admission control sheds a due
request that waited past `timeout_s` and the tail past `queue_limit`.

Timing: every prefill and decode step ends in `torch.cuda.synchronize()`
on the card, so a step's latency is device time. Steady-state tok/s and the
p50/p99 per-token latencies exclude prefill, the first `--warmup-steps`
decode steps (the reference's compile step) and every decode step that ran
a program's eager first call or captured a CUDA graph
(`dispatch.compiled`): the reference compiles before its window, so a
*capture step* is left out as its compile step is. The report lists the
capture steps and their ms, the capture seconds inside every prefill and
decode step, and marks each prefill eager, capture or replay.

On the float path (no --cim-lower) the engine runs the reference's jitted
steps as programs (`dispatch.Program`, one CUDA graph each per signature
on the card): the prefill keyed on its input shapes (the reference's jit
retraces per prompt length), the decode step with the batched caches
donated (the reference's `donate_argnums=(0,)`: the engine's caches are
the graph's, and the step leaves its new caches in them) and the slot
insert with the batched caches donated and the slot a device integer.
Sampling stays outside the graphs, as in the reference. With --cim-lower
the decode step stays eager around its graphed CiM programs (the
reference leaves it unjitted and its retry reruns it on the same caches),
and so do the prefill and the insert.

With --cim-lower every decode MLP and global-attention contraction runs
through the lowering compiler (`repro_torch.cim.lower`): each is one fused
region, a planned ADRA access schedule whose accesses are launches of the
fused bit-plane kernel, and the report's offload-policy line counts the
cost model's verdicts; `accesses` is the compute bill, `load_accesses` the
streamed-operand row-write bill. The prefill runs eagerly and charges the
ledger on every call (the reference's jitted prefill charges once, at
trace time). The bench runs the SAME request schedule twice — streamed
repack, then resident — and asserts that the resident phase charges the
same compute accesses per token and strictly fewer total accesses per
token; --assert-warm replays the resident phase and asserts zero program
misses and zero new pins. --cim-faults adds a chaos phase: the resident
run again with ECC-protected pins under the REPRO_CIM_FAULT_* campaign
(fail-stop), asserting tokens identical to the fault-free run, 0
uncorrected bits, and corrected > 0 when the resident BER is.

The resident array is decided in one place, `resident_array_spec`, and
printed on the report's `array:` line beside the paper's. The paper's
1024-word bitlines give 4096-word tiles: a full-width gemma-2b decode
weight pin (2^26 words at 2 slots) would need 32768 rows per bank against
a 768-row resident budget, so it would stay streamed (the reference's
residency planning decides the same) and no slot count or prompt length
changes that. The serve path therefore widens the bitlines until the
largest decode weight pin fills one tile (gemma-2b: 2^24 words per
bitline; recurrentgemma-9b: 2^25). One-tile pins all land on bank 0, so it
then doubles the rows until bank 0's budget holds every decode weight pin
and KV reservation: gemma-2b keeps the paper's 1024 rows (448 of 768
held), recurrentgemma-9b's 114 pins and its KV blocks need 2048 (928 of
1536). The accesses and dispatches of a decode step are the plan's and do
not depend on the array.
"""
from __future__ import annotations

import argparse
import dataclasses
import json as json_lib
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.cim import accounting, cost, dispatch
from repro_torch.cim import array as array_mod
from repro_torch.cim import faults as faults_mod
from repro_torch.cim import planner
from repro_torch.cim.array import (DEFAULT_SPEC, ArraySpec, clear_resident,
                                   registry_reserve_rows, resident_set,
                                   set_current_spec)
from repro_torch.cim.planepack import ecc_plane_count
from repro_torch.configs import preset_config
from repro_torch.launch.paged_kv import PagedKV
from repro_torch.models.model import (XLSTM_CELLS, Model, build,
                                      dense_mlp_width, is_moe_layer,
                                      stack_kinds, with_cim)
from repro_torch.train import (adra_sample, greedy_sample, make_decode_step,
                               make_prefill_step)


@dataclasses.dataclass
class ServeRequest:
    """One queued generation job and its measured lifecycle. `prompt`
    fixes the prompt tokens; without it they are drawn from the engine's
    seeded generator."""

    rid: int
    prompt_len: int
    gen: int                       # tokens to produce (incl. the prefill one)
    arrival_s: float = 0.0
    prompt: Optional[List[int]] = None
    slot: int = -1
    tokens: List[int] = dataclasses.field(default_factory=list)
    prefill_ms: float = 0.0
    prefill_kind: str = ""         # eager, capture or replay (see `_kind`)
    prefill_capture_s: float = 0.0
    first_token_s: float = -1.0
    done_s: float = -1.0
    accesses: float = 0.0          # ledger attribution (see module docstring)
    load_accesses: float = 0.0
    token_latencies_ms: List[float] = dataclasses.field(default_factory=list)
    shed: bool = False             # dropped by admission control, never ran
    repairs: int = 0               # retried decode steps attributed here

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.gen

    def report(self) -> Dict[str, Any]:
        return {
            "rid": self.rid,
            "arrival_s": round(self.arrival_s, 6),
            "first_token_s": round(self.first_token_s, 6),
            "done_s": round(self.done_s, 6),
            "prefill_ms": round(self.prefill_ms, 3),
            "prefill_kind": self.prefill_kind,
            "prefill_capture_s": round(self.prefill_capture_s, 6),
            "tokens": len(self.tokens),
            "token_ids": list(self.tokens),
            "shed": self.shed,
            "repairs": self.repairs,
            "accesses": round(self.accesses, 3),
            "load_accesses": round(self.load_accesses, 3),
            "total_accesses": round(self.accesses + self.load_accesses, 3),
        }


def _percentile(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    ys = sorted(xs)
    i = min(len(ys) - 1, max(0, int(round(q / 100.0 * (len(ys) - 1)))))
    return ys[i]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mean(xs: List[float]) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None


def _delta(before: Dict[str, float], after: Dict[str, float]
           ) -> Dict[str, float]:
    return {k: after[k] - before[k] for k in after}


def _kind(before: Dict[str, float], after: Dict[str, float]) -> str:
    """A prefill's kind from the graph counters around it: "capture" if
    it captured a graph, "eager" if it ran a program's eager first call
    on a graph device or graphed nothing (a plain device, an eager CiM
    prefill with no program), else "replay"."""
    if after["captured"] > before["captured"]:
        return "capture"
    if after["eager"] > before["eager"] \
            or after["replays"] == before["replays"]:
        return "eager"
    return "replay"


def _insert_body(caches, single, slot: torch.Tensor):
    """Land the batch-1 caches `single` in batch row `slot` (a device
    int64 [1]) of the batched `caches`, in place; returns (caches,), the
    donated leaf's new value."""
    for c, s in zip(caches, single):
        for name in c:
            c[name].index_copy_(0, slot, s[name].to(c[name].dtype))
    return (caches,)


class ServeEngine:
    """Slot-based continuous batching over one batched cache. `spec` is the
    CiM geometry the engine serves from (what a bank kill degrades);
    `retry_budget` bounds the retries of a decode step per request,
    `queue_limit` the due requests waiting beyond the free slots,
    `timeout_s` a due request's wait for a slot, and `scrub_every` the
    decode steps between ECC scrub passes (0: none)."""

    def __init__(self, model: Model, slots: int, max_len: int,
                 sampler: str = "greedy", cim_lower: bool = False,
                 paged: Optional[PagedKV] = None, warmup_steps: int = 1,
                 seed: int = 0, spec: Optional[ArraySpec] = None,
                 retry_budget: int = 2, queue_limit: Optional[int] = None,
                 timeout_s: Optional[float] = None, scrub_every: int = 0):
        self.model, self.cfg = model, model.cfg
        self.device = model.device
        self.slots, self.max_len = int(slots), int(max_len)
        if sampler not in ("greedy", "adra"):
            raise ValueError(f"unknown sampler {sampler!r}")
        self.sample = greedy_sample if sampler == "greedy" else adra_sample
        self.cim_lower = cim_lower
        self.paged = paged
        self.warmup_steps = int(warmup_steps)
        self.seed = int(seed)
        self.spec = spec
        self.retry_budget = int(retry_budget)
        self.queue_limit = queue_limit
        self.timeout_s = timeout_s
        self.scrub_every = int(scrub_every)
        self.repairs = 0                      # uncorrectable -> re-pin+retry
        self.failovers = 0                    # bank-kill remaps executed
        self.shed_count = 0
        self.scrub_report = {"scanned": 0, "dropped": 0,
                             "corrected": 0, "uncorrected": 0}
        self.prefill_fn = make_prefill_step(model, max_len)
        self.decode_fn = make_decode_step(model)
        self.insert_fn = _insert_body
        #: the float path's step programs, by name (none with --cim-lower)
        self.programs: Dict[str, dispatch.Program] = {}
        if not cim_lower:
            self.programs = {
                "prefill": dispatch.Program(self.prefill_fn),
                "decode": dispatch.Program(self.decode_fn, donate=(0,)),
                "insert": dispatch.Program(self.insert_fn, donate=(0,))}
            self.prefill_fn = self.programs["prefill"]
            self.decode_fn = self.programs["decode"]
            self.insert_fn = self.programs["insert"]
        # the slot of an insert as a device integer: a graph replays it
        self._slot_ids = [torch.tensor([i], dtype=torch.int64,
                                       device=self.device)
                          for i in range(self.slots)]

    # -- fault handling ------------------------------------------------------

    def _check_faults(self, step: int) -> None:
        """Advance the installed FaultModel to `step` and fail over when it
        has killed a bank this engine still serves from."""
        fm = faults_mod.active()
        if fm is None:
            return
        fm.on_step(step)
        if self.spec is None or not self.cim_lower:
            return
        dead = [b for b in fm.dead_banks
                if b not in self.spec.disabled_banks and b < self.spec.banks]
        if dead:
            self._failover(dead)

    def _failover(self, dead_banks: List[int]) -> None:
        """Remap the serving process off `dead_banks`: degraded spec, paged
        KV migrated (all or nothing), stale weight pins dropped so they
        re-pin under the new geometry, and the process-wide spec override
        installed, so every spec=None layer re-routes from the next call
        on (its fresh lowering re-plans, demoting what no longer pays)."""
        new_spec = self.spec
        for b in dead_banks:
            new_spec = new_spec.disable_bank(b)
        new_rs = resident_set(new_spec)
        if self.paged is not None:
            self.paged.migrate(new_spec, new_rs)
        old_rs = array_mod._RESIDENT_SETS.get(self.spec)
        if old_rs is not None and old_rs is not new_rs:
            old_rs.clear()              # stale pins: re-pin under new_spec
        set_current_spec(new_spec)
        self.spec = new_spec
        self.failovers += 1

    def _scrub(self) -> None:
        rs = array_mod._RESIDENT_SETS.get(self.spec)
        if rs is None or not rs.ecc:
            return
        r = rs.scrub()
        for k in self.scrub_report:
            self.scrub_report[k] += r.get(k, 0)

    def _gen(self, stream: int) -> torch.Generator:
        return torch.Generator().manual_seed(self.seed * 1_000_003 + stream)

    def _prompt_inputs(self, req: ServeRequest) -> Dict[str, torch.Tensor]:
        """A request's prompt: its tokens, or for an embed-stub config
        seeded pseudo-embeddings [1, prompt_len, d_model] * 0.02 (the
        reference's scale), from the engine's generator stream `rid`."""
        if self.cfg.embed_stub:
            emb = torch.randn((1, req.prompt_len, self.cfg.d_model),
                              generator=self._gen(req.rid)) * 0.02
            return {"embeds": emb.to(self.device)}
        if req.prompt is not None:
            toks = torch.tensor([req.prompt], dtype=torch.int64)
        else:
            toks = torch.randint(0, self.cfg.vocab_size, (1, req.prompt_len),
                                 generator=self._gen(req.rid))
        return {"tokens": toks.to(self.device)}

    def _step_inputs(self, tok: torch.Tensor, positions: List[int],
                     step: int) -> Dict[str, torch.Tensor]:
        """One decode step's inputs: the sampled tokens, or for an
        embed-stub config fresh pseudo-embeddings [slots, 1, d_model] *
        0.02 from stream 10000 + step, as the reference draws them."""
        pos = torch.tensor(positions, dtype=torch.int32, device=self.device)
        if self.cfg.embed_stub:
            emb = torch.randn((self.slots, 1, self.cfg.d_model),
                              generator=self._gen(10_000 + step)) * 0.02
            return {"embeds": emb.to(self.device), "positions": pos}
        return {"tokens": tok[:, None], "positions": pos}

    def _insert(self, caches, single, slot: int) -> None:
        """Land a batch-1 prefill cache in slot `slot` (in place: the
        batched cache belongs to this engine alone)."""
        self.insert_fn(caches, single, self._slot_ids[slot])

    def run(self, requests: List[ServeRequest]) -> Dict[str, Any]:
        led = accounting.ledger()
        pending = deque(sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
        active: Dict[int, ServeRequest] = {}
        free = list(range(self.slots))
        caches = self.model.init_caches(self.slots, self.max_len)
        tok = torch.zeros((self.slots,), dtype=torch.int64, device=self.device)
        positions = [0] * self.slots
        decode_steps = 0
        steady_tokens = 0
        steady_time = 0.0
        token_lat_ms: List[float] = []
        step_accesses: List[int] = []
        step_dispatches: List[int] = []
        step_capture_s: List[float] = []
        capture_steps: List[int] = []
        capture_step_ms: List[float] = []
        g_run = dispatch.graph_stats()
        t0 = time.perf_counter()

        def now() -> float:
            return time.perf_counter() - t0

        def shed(req: ServeRequest) -> None:
            req.shed = True
            req.done_s = now()
            self.shed_count += 1

        while pending or active:
            self._check_faults(decode_steps)

            # admission control: shed the head once it has waited past the
            # timeout for a slot, and the tail past free slots + queue_limit
            if self.timeout_s is not None and not free:
                while pending and pending[0].arrival_s <= now() \
                        and now() - pending[0].arrival_s > self.timeout_s:
                    shed(pending.popleft())
            if self.queue_limit is not None:
                while sum(1 for r in pending if r.arrival_s <= now()) \
                        - len(free) > self.queue_limit:
                    shed(pending.pop())

            if pending and free and pending[0].arrival_s <= now():
                req = pending[0]
                if self.paged is not None and \
                        not self.paged.alloc(req.rid, req.prompt_len):
                    if not active:
                        raise RuntimeError(
                            f"request {req.rid}: prompt of {req.prompt_len} "
                            f"tokens cannot fit the KV block pool even with "
                            f"every slot idle")
                else:
                    pending.popleft()
                    slot = free.pop(0)
                    req.slot = slot
                    g0 = dispatch.graph_stats()
                    ta = time.perf_counter()
                    l0 = (led.accesses, led.load_accesses)
                    c1, logits1 = self.prefill_fn(self._prompt_inputs(req))
                    _sync(self.device)
                    req.prefill_ms = (time.perf_counter() - ta) * 1e3
                    g1 = dispatch.graph_stats()
                    req.prefill_kind = _kind(g0, g1)
                    req.prefill_capture_s = g1["capture_s"] - g0["capture_s"]
                    req.accesses += led.accesses - l0[0]
                    req.load_accesses += led.load_accesses - l0[1]
                    self._insert(caches, c1, slot)
                    first = int(self.sample(logits1)[0])
                    tok[slot] = first
                    req.tokens.append(first)
                    req.first_token_s = now()
                    positions[slot] = req.prompt_len
                    active[slot] = req
                    if req.done:
                        self._retire(req, free, active, now())
                    continue                           # admit before decode

            if not active:
                if pending:
                    time.sleep(max(0.0, pending[0].arrival_s - now()))
                continue

            step_in = self._step_inputs(tok, positions, decode_steps)
            g0 = dispatch.graph_stats()
            ts = time.perf_counter()
            l0 = (led.accesses, led.load_accesses)
            d0 = dispatch.cache_stats()["dispatches"]
            # one full-batch decode step, retried within the budget when an
            # ECC verify finds uncorrectable damage (the failing pin is
            # already invalidated, so the retry re-pins from the weights)
            attempts = 0
            while True:
                try:
                    caches, logits = self.decode_fn(caches, step_in)
                    break
                except faults_mod.UncorrectableFaultError:
                    attempts += 1
                    self.repairs += 1
                    for req in active.values():
                        req.repairs += 1
                    if attempts > self.retry_budget:
                        raise
            _sync(self.device)
            dt = time.perf_counter() - ts
            g1 = dispatch.graph_stats()
            d_acc = led.accesses - l0[0]
            d_load = led.load_accesses - l0[1]
            tok = self.sample(logits).to(torch.int64)
            # a step's counts include its sampler's accesses (none: greedy)
            step_accesses.append(led.accesses - l0[0])
            step_dispatches.append(dispatch.cache_stats()["dispatches"] - d0)
            tok_host = tok.tolist()
            n_active = len(active)
            decode_steps += 1
            step_capture_s.append(g1["capture_s"] - g0["capture_s"])
            # a step that compiled is the reference's compile step: out of
            # the window, whatever its index
            captured = dispatch.compiled(g0, g1)
            if captured:
                capture_steps.append(decode_steps)
                capture_step_ms.append(dt * 1e3)
            steady = decode_steps > self.warmup_steps and not captured
            if steady:
                steady_tokens += n_active
                steady_time += dt
            for slot, req in list(active.items()):
                req.tokens.append(int(tok_host[slot]))
                req.accesses += d_acc / n_active
                req.load_accesses += d_load / n_active
                req.token_latencies_ms.append(dt * 1e3)
                if steady:
                    token_lat_ms.append(dt * 1e3)
                positions[slot] += 1
                if self.paged is not None:
                    self.paged.extend(req.rid)
                if req.done:
                    self._retire(req, free, active, now())
            if self.scrub_every and decode_steps % self.scrub_every == 0:
                self._scrub()

        total_tokens = sum(len(r.tokens) for r in requests)
        decode_tokens = sum(max(0, len(r.tokens) - 1) for r in requests)
        report: Dict[str, Any] = {
            "device": str(self.device),
            "slots": self.slots,
            "requests": len(requests),
            "total_tokens": total_tokens,
            "decode_tokens": decode_tokens,
            "decode_steps": decode_steps,
            "warmup_steps": self.warmup_steps,
            "wall_s": now(),
            "tok_s_steady": (steady_tokens / steady_time
                             if steady_time > 0 else 0.0),
            "steady_tokens": steady_tokens,
            "p50_ms": _percentile(token_lat_ms, 50),
            "p99_ms": _percentile(token_lat_ms, 99),
            "prefill_ms_mean": (sum(r.prefill_ms for r in requests)
                                / max(1, len(requests))),
            # the prefills that neither ran an eager first call nor
            # captured (None: none did)
            "prefill_ms_replay_mean": _mean([
                r.prefill_ms for r in requests
                if not r.shed and r.prefill_kind == "replay"]),
            "capture_steps": capture_steps,
            "capture_step_ms": capture_step_ms,
            "step_capture_s": step_capture_s,
            # what this run captured and replayed (0 on plain devices)
            "graphs": _delta(g_run, dispatch.graph_stats()),
            "shed": self.shed_count,
            "completed": sum(1 for r in requests if not r.shed and r.done),
            "step_accesses": step_accesses,
            "step_dispatches": step_dispatches,
            "per_request": [r.report() for r in requests],
        }
        if self.programs:
            report["step_graphs"] = {k: dict(p.stats)
                                     for k, p in self.programs.items()}
        fm = faults_mod.active()
        if fm is not None or self.repairs or self.failovers:
            report["faults"] = {
                **(fm.stats() if fm is not None else {}),
                "repairs": self.repairs,
                "failovers": self.failovers,
                "shed": self.shed_count,
                "scrub": dict(self.scrub_report),
            }
            rst = array_mod.resident_stats()
            for k in ("ecc_verifies", "ecc_corrected", "ecc_uncorrected"):
                report["faults"][k] = rst.get(k, 0)
        if self.paged is not None:
            st = self.paged.stats()
            report["kv"] = {
                "n_blocks": st.n_blocks, "block_tokens": st.block_tokens,
                "peak_blocks": st.peak_blocks,
                "failed_allocs": st.failed_allocs,
                "utilization_peak": st.peak_blocks / max(1, st.n_blocks),
            }
        if self.cim_lower:
            per_tok = max(1, decode_tokens)
            report["ledger"] = {
                "accesses": led.accesses,
                "load_accesses": led.load_accesses,
                "total_accesses": led.total_accesses,
                "resident_reuses": led.resident_reuses,
            }
            report["accesses_per_token"] = round(led.accesses / per_tok, 4)
            report["load_accesses_per_token"] = round(
                led.load_accesses / per_tok, 4)
            report["total_accesses_per_token"] = round(
                led.total_accesses / per_tok, 4)
            report["offload"] = dict(cost.PLAN_STATS)
        return report

    def _retire(self, req: ServeRequest, free, active, t: float) -> None:
        req.done_s = t
        if req.slot in active:
            del active[req.slot]
        free.append(req.slot)
        free.sort()
        if self.paged is not None:
            self.paged.free(req.rid)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def make_requests(args) -> List[ServeRequest]:
    return [ServeRequest(rid=i, prompt_len=args.prompt_len, gen=args.gen,
                         arrival_s=i * args.arrival_interval)
            for i in range(args.requests)]


def fresh_cim_state() -> None:
    accounting.ledger().reset()
    clear_resident()
    dispatch.clear_schedule_cache()
    cost.reset_plan_stats()
    set_current_spec(None)
    faults_mod.reset_fault_stats()


def _decode_weight_pins(cfg, slots: int) -> List[int]:
    """Word counts of the int8 MLP weight pins of one decode step: the
    [slots, K_pad, N] broadcast layouts (`matmul_rhs_pack`) of every layer
    whose MLP runs on CiM, at its own width. xLSTM layers have no MLP and
    MoE layers run their experts in float (the reference lowers only dense
    MLPs): DeepSeek pins its dense layer 0 alone, at d_ff_first_dense."""
    pins: List[int] = []
    for i, kind in enumerate(stack_kinds(cfg)):
        if kind in XLSTM_CELLS or is_moe_layer(cfg, i):
            continue
        f = dense_mlp_width(cfg, kind)
        shapes = [(cfg.d_model, f), (f, cfg.d_model)]
        if cfg.gating in ("swiglu", "geglu"):
            shapes.append((cfg.d_model, f))
        pins += [slots * (1 << planner._log2_ceil(k)) * n for k, n in shapes]
    return pins


def resident_array_spec(cfg, slots: int, max_len: int,
                        ecc: bool = False) -> ArraySpec:
    """The array a --cim-lower run pins weights and KV pages in (see the
    module docstring): the paper's geometry with its bitlines doubled until
    the largest decode weight pin fills one tile, then its rows doubled
    until the registry ResidentSet's budget on each bank holds every decode
    weight pin (with its SECDED parity rows when `ecc`) and KV reservation
    that lands there."""
    if cfg.cim_mlp_bits < 1:
        raise ValueError(f"{cfg.name}: resident pins need cim_mlp_bits > 0")
    pins = _decode_weight_pins(cfg, slots)
    words = DEFAULT_SPEC.bitline_words
    while DEFAULT_SPEC.subarrays * words < max(pins, default=0):
        words *= 2
    spec = dataclasses.replace(DEFAULT_SPEC, bitline_words=words)
    pin_rows = cfg.cim_mlp_bits + (ecc_plane_count(cfg.cim_mlp_bits)
                                   if ecc else 0)
    rows_by_bank: Dict[int, int] = {}
    for n_words in pins:
        for (_dev, bank), n in spec.plan(n_words).bank_counts(1).items():
            rows_by_bank[bank] = rows_by_bank.get(bank, 0) + pin_rows * n
    paged = PagedKV.for_model(cfg, spec=spec, slots=slots, max_len=max_len)
    for bid in range(paged.n_blocks):
        bank = paged.bank_of_block(bid)
        rows_by_bank[bank] = rows_by_bank.get(bank, 0) + paged.kv_bits
    need = max(rows_by_bank.values())
    while spec.rows - registry_reserve_rows(spec) < need:
        spec = dataclasses.replace(spec, rows=2 * spec.rows)
    return spec


def array_line(spec: ArraySpec) -> str:
    """The serve report's line naming the array used beside the paper's."""
    return ", ".join(
        f"{f.replace('_', ' ')} {getattr(spec, f)} "
        f"(paper {getattr(DEFAULT_SPEC, f)})"
        for f in ("banks", "subarrays", "rows", "bitline_words"))


def serve_once(model: Model, args, requests=None) -> Dict[str, Any]:
    """One pass of the request schedule through a fresh engine (on the
    resident array, ECC rows included while `set_resident_ecc` is on)."""
    cfg = model.cfg
    spec = rs = None
    max_len = args.prompt_len + args.gen
    if args.cim_lower:
        spec = resident_array_spec(cfg, args.slots, max_len,
                                   ecc=array_mod.resident_ecc_default())
        rs = resident_set(spec)
        model = model.derive(cfg, resident_spec=spec)
    paged = PagedKV.for_model(cfg, spec=spec, slots=args.slots,
                              max_len=max_len, resident_set=rs)
    engine = ServeEngine(model, slots=args.slots, max_len=max_len,
                         sampler=args.sampler, cim_lower=args.cim_lower,
                         paged=paged, warmup_steps=args.warmup_steps,
                         seed=args.seed, spec=spec,
                         scrub_every=args.scrub_every)
    return engine.run(requests if requests is not None else make_requests(args))


def print_cim_report(tag: str) -> None:
    led = accounting.ledger()
    proj = led.projected()
    hist = ", ".join(f"{k}:{v}" for k, v in sorted(led.per_op.items()))
    print(f"cim ledger ({tag}): {led.accesses} compute accesses + "
          f"{led.load_accesses} streamed loads = {led.total_accesses} total, "
          f"{led.resident_reuses} resident reuses, "
          f"{led.words32:.0f} word32-ops")
    print(f"  per-op: {hist}")
    print(f"  projected: {proj['edp_decrease_pct']:.1f}% EDP decrease, "
          f"{proj['energy_saved_fj']:.0f} fJ saved vs near-memory "
          f"(current sensing @1024^2)")
    cs = dispatch.cache_stats()
    print(f"  schedule cache: {cs['hits']} hits / {cs['misses']} misses, "
          f"{cs['dispatches']} dispatches; resident: "
          f"{cs['resident_pins']} pins / {cs['resident_hits']} hits / "
          f"{cs['resident_evictions']} evictions, "
          f"{cs['resident_rows']} rows held")
    gs = dispatch.graph_stats()
    print(f"  graphs: {gs['captured']} captured, {gs['replays']} replays, "
          f"{gs['capture_s']:.3f} s capturing, {gs['eager']} eager first "
          f"calls")
    ps = cost.PLAN_STATS
    print(f"  offload policy: {ps['plans']} plans cut, "
          f"{ps['eqns_lowered']} eqns lowered / {ps['eqns_demoted']} "
          f"demoted ({ps['demoted_accesses']} accesses kept on host), "
          f"{ps['fused_despite_loss']} losing eqns kept fused")


def chaos_phase(model_resident: Model, args,
                resident: Dict[str, Any]) -> Dict[str, Any]:
    """The resident run again under the env-configured fault campaign with
    ECC-protected pins and fail-stop ECC: tokens must equal the fault-free
    `resident` run's, with 0 uncorrected bits, and ECC must have corrected
    something when the resident BER is above 0."""
    fresh_cim_state()
    array_mod.set_resident_ecc(True)
    fcfg = faults_mod.FaultConfig.from_env(raise_on_uncorrectable=True)
    try:
        with faults_mod.faults(fcfg):
            chaos = serve_once(model_resident, args)
    finally:
        array_mod.set_resident_ecc(False)
        set_current_spec(None)
    fr = chaos.get("faults", {})
    assert [r["token_ids"] for r in chaos["per_request"]] == \
        [r["token_ids"] for r in resident["per_request"]], \
        "chaos phase tokens diverged from the fault-free run"
    assert fr.get("uncorrected", 0) == 0, \
        f"chaos phase left {fr.get('uncorrected')} uncorrected bits"
    if fcfg.resident_ber > 0:
        assert fr.get("corrected", 0) > 0, \
            "resident BER configured but ECC corrected nothing"
    print(f"chaos phase (seed {fcfg.seed}, resident BER "
          f"{fcfg.resident_ber:g}): identical tokens, "
          f"{fr.get('injected', 0)} bits injected / "
          f"{fr.get('corrected', 0)} corrected / 0 uncorrected, "
          f"{fr.get('ecc_verifies', 0)} verifies, repairs "
          f"{fr.get('repairs', 0)}, {chaos['tok_s_steady']:.2f} tok/s "
          f"under verify")
    return chaos


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--preset", default="reduced", choices=("reduced", "full"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    ap.add_argument("--slots", "--batch", type=int, default=4, dest="slots")
    ap.add_argument("--requests", type=int, default=0,
                    help="queued requests (default: one per slot)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--arrival-interval", type=float, default=0.0)
    ap.add_argument("--warmup-steps", type=int, default=1)
    ap.add_argument("--sampler", default="greedy", choices=("greedy", "adra"))
    ap.add_argument("--json", default="")
    ap.add_argument("--cim-lower", action="store_true",
                    help="run decode MLPs and attention contractions as CiM "
                         "schedules and bench repack vs resident phases")
    ap.add_argument("--cim-bits", type=int, default=8)
    ap.add_argument("--cim-resident", action="store_true",
                    help="pin int8 MLP weight planes in array rows")
    ap.add_argument("--assert-warm", action="store_true",
                    help="replay the resident phase and fail unless every "
                         "program and pin stayed warm")
    ap.add_argument("--cim-faults", action="store_true",
                    help="with --cim-lower: run a chaos phase under the "
                         "REPRO_CIM_FAULT_SEED/BER env fault campaign with "
                         "ECC-protected pins, asserting tokens identical to "
                         "the fault-free phase")
    ap.add_argument("--scrub-every", type=int, default=0,
                    help="decode steps between ECC scrub passes (0: off)")
    args = ap.parse_args(argv)
    if args.requests <= 0:
        args.requests = args.slots
    return args


def main(argv=None, model: Optional[Model] = None) -> Dict[str, Any]:
    """Run the serve bench; returns its report. `model` reuses a built
    model (its config is re-derived from the arguments)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = preset_config(args.arch, args.preset)
    if args.cim_lower:
        cfg = with_cim(cfg, args.cim_bits)
    if args.cim_resident and not args.cim_lower:
        cfg = dataclasses.replace(cfg, cim_resident=True)
    if model is None:
        model = build(cfg, device=device, seed=args.seed, for_serving=True)
    else:
        model = model.derive(cfg)

    out: Dict[str, Any] = {
        "bench": "serve", "arch": args.arch, "preset": args.preset,
        "device": str(device), "slots": args.slots,
        "requests": args.requests, "prompt_len": args.prompt_len,
        "gen": args.gen, "sampler": args.sampler,
        "cim": {"lower": bool(args.cim_lower), "bits": args.cim_bits,
                "resident": bool(args.cim_resident)},
    }
    if args.cim_lower:
        spec = resident_array_spec(cfg, args.slots, args.prompt_len + args.gen)
        out["cim"]["array"] = dataclasses.asdict(spec)
        print(f"array: {array_line(spec)}")
    if not args.cim_lower:
        rep = serve_once(model, args)
        out.update(rep)
        print(f"served {rep['requests']} requests / {rep['total_tokens']} "
              f"tokens in {rep['wall_s']:.2f}s: {rep['tok_s_steady']:.1f} "
              f"tok/s steady, p50 {rep['p50_ms']:.1f} ms, "
              f"p99 {rep['p99_ms']:.1f} ms; "
              f"{len(rep['capture_steps'])} capture steps left out")
    else:
        model_resident = model.derive(dataclasses.replace(cfg,
                                                          cim_resident=True))
        fresh_cim_state()
        repack = serve_once(model, args)
        print_cim_report("repack")
        fresh_cim_state()
        resident = serve_once(model_resident, args)
        print_cim_report("resident")
        assert resident["accesses_per_token"] == repack["accesses_per_token"], \
            (f"compute accesses/token must not change with residency: "
             f"{resident['accesses_per_token']} != "
             f"{repack['accesses_per_token']}")
        assert resident["total_accesses_per_token"] \
            < repack["total_accesses_per_token"], \
            (f"resident serving must charge strictly fewer total "
             f"accesses/token: {resident['total_accesses_per_token']} !< "
             f"{repack['total_accesses_per_token']}")
        assert resident["ledger"]["resident_reuses"] > 0
        out["phases"] = {"repack": repack, "resident": resident}
        if args.assert_warm:
            cs0 = dispatch.cache_stats()
            warm = serve_once(model_resident, args)
            cs1 = dispatch.cache_stats()
            miss_delta = cs1["misses"] - cs0["misses"]
            pin_delta = cs1["resident_pins"] - cs0["resident_pins"]
            assert miss_delta == 0, \
                f"warm replay compiled {miss_delta} new programs"
            assert pin_delta == 0, \
                f"warm replay re-pinned {pin_delta} resident operands"
            assert warm["tok_s_steady"] > 0
            out["phases"]["warm"] = warm
            out["warm_replay"] = {
                "tok_s_steady": warm["tok_s_steady"],
                "program_cache_miss_delta": miss_delta,
                "resident_pin_delta": pin_delta,
            }
            print(f"warm replay: {warm['tok_s_steady']:.2f} tok/s, "
                  f"0 new programs, 0 new pins")
        ratio = resident["tok_s_steady"] / max(1e-9, repack["tok_s_steady"])
        out["tok_s_resident_vs_repack_ratio"] = ratio
        for k in ("accesses_per_token", "load_accesses_per_token",
                  "total_accesses_per_token", "tok_s_steady", "p50_ms",
                  "p99_ms"):
            out[k] = resident[k]
        print(f"resident vs repack: {resident['tok_s_steady']:.2f} vs "
              f"{repack['tok_s_steady']:.2f} tok/s (x{ratio:.2f}), total "
              f"accesses/token {resident['total_accesses_per_token']} vs "
              f"{repack['total_accesses_per_token']}")
        if args.cim_faults:
            out["phases"]["chaos"] = chaos_phase(model_resident, args,
                                                 resident)
    if args.json:
        with open(args.json, "w") as f:
            json_lib.dump(out, f, indent=2, sort_keys=True)
        print(f"wrote {args.json}")
    return out


if __name__ == "__main__":
    # read at the first CUDA allocation: freed blocks stay usable by the
    # next, differently sized prefill allocation (the full-width hybrid
    # serves within a few GB of the card's 80)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    main()
