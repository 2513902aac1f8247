"""The serve cells: the port's `ServeEngine` driven by a traffic file's
requests, timed from the client's side, and its served tokens held to the
plain reference afterwards.

A traffic file of kind "serve" gives the path ("cim": `--cim-lower` with
resident pins; "float"), the slots, one prompt length and `round_gens`,
the output lengths of one round's requests in their order. Round r's
prompts are drawn uniformly over the vocabulary from (seed, r); every
seed serves the same lengths in the same order, because the order decides
how the closed loop drains and so the work of a run. A cell's own file
(`cells/<cell>.json`) gives
`rounds_per_s`: a window of `--seconds` serves ceil(seconds x rounds_per_s)
rounds (at least one), a fixed amount of work that takes about that long.

One `ServeEngine.run` serves a run's whole list, a closed loop that admits
the next request whenever a slot is free: first a warm-up request in every
slot (`warmup_gens`, each 3 tokens: a prefill and two decode steps), whose
prefills, inserts and two decode steps run each program's eager first call
and capture its graph; the window opens when the last of them retires and
closes when the list is drained. So the window replays only (checked), and
the engine runs once: a second `run` on one engine is not sound on the
float path (PERF.md, Open questions).

A `Recorder` wraps the engine's own calls from outside (prompt inputs,
insert, step inputs, decode, sampling): it keeps each event with its host
time, which gives the window's start, the gaps between a request's tokens,
each decode step's time, and the batches the reference replays.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from . import check, common
from .trace import Tracer

#: rid of round r's request i is (r + 1) * ROUND_RIDS + i; the warm-up
#: requests take 0, 1, ...
ROUND_RIDS = 1000


def round_requests(traffic: Dict[str, Any], vocab: int, seed: int, r,
                   gens=None, rid0: Optional[int] = None
                   ) -> List[Dict[str, Any]]:
    """Round r's requests (r a number, or "warm" for the warm-up):
    (rid, prompt ids, output length, round)."""
    gens = list(traffic["round_gens"] if gens is None else gens)
    rng = np.random.default_rng(common.sub_seed(seed, "round", r))
    prompts = rng.integers(0, vocab, size=(len(gens), int(traffic["prompt_len"])))
    rid0 = (int(r) + 1) * ROUND_RIDS if rid0 is None else rid0
    return [{"rid": rid0 + i, "prompt": [int(t) for t in prompts[i]],
             "gen": int(g), "round": r} for i, g in enumerate(gens)]


class Recorder:
    """Events of an engine's run, from wrappers around its calls: ("p",
    rid, slot) for an admission, ("d", tokens, positions) for a decode
    step, each with the host time its token(s) came out (after a
    synchronise), and each decode step's seconds. `on_token` is called
    after each event."""

    def __init__(self, engine, device: torch.device,
                 on_token: Callable[[Dict[str, Any]], None]):
        self.events: List[Dict[str, Any]] = []
        self.step_s: List[float] = []
        self.device = device
        self.tracer = Tracer(False, 0.0, device)
        self._rid: Optional[int] = None
        self._pending: Optional[Dict[str, Any]] = None
        e = engine
        prompt_inputs, insert = e._prompt_inputs, e._insert
        step_inputs, decode, sample = e._step_inputs, e.decode_fn, e.sample
        prefill = e.prefill_fn

        def _prompt_inputs(req):
            self._rid = req.rid
            return prompt_inputs(req)

        def _prefill(inputs):
            with self.tracer.span("prefill"):
                return prefill(inputs)

        def _insert(caches, single, slot):
            self._pending = {"kind": "p", "rid": self._rid, "slot": int(slot)}
            with self.tracer.span("insert"):
                return insert(caches, single, slot)

        def _step_inputs(tok, positions, step):
            self._pending = {"kind": "d", "tokens": tok.detach().clone(),
                             "positions": list(positions)}
            return step_inputs(tok, positions, step)

        def _decode(caches, step_in):
            t0 = time.perf_counter()
            with self.tracer.span("decode"):
                out = decode(caches, step_in)
                self._sync()
            self.step_s.append(time.perf_counter() - t0)
            return out

        def _sample(logits):
            with self.tracer.span("sample"):
                tok = sample(logits)
                self._sync()
            ev, self._pending = self._pending, None
            ev["t"] = time.perf_counter()
            self.events.append(ev)
            on_token(ev)
            self.tracer.tick()
            return tok

        e._prompt_inputs, e._insert = _prompt_inputs, _insert
        e._step_inputs, e.decode_fn, e.sample = _step_inputs, _decode, _sample
        e.prefill_fn = _prefill

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def token_times(events: List[Dict[str, Any]], gens: Dict[int, int]
                ) -> Dict[int, List[float]]:
    """Each request's token times: its admission's, then one per decode
    step while it is in its slot (the engine gives every active request a
    token each step and retires it at its length)."""
    times: Dict[int, List[float]] = {}
    active: Dict[int, int] = {}
    for ev in events:
        if ev["kind"] == "p":
            times[ev["rid"]] = [ev["t"]]
            if gens[ev["rid"]] > 1:
                active[ev["slot"]] = ev["rid"]
            continue
        for slot, rid in list(active.items()):
            times[rid].append(ev["t"])
            if len(times[rid]) >= gens[rid]:
                del active[slot]
    return times


def build_engine(arch, traffic, weights, device):
    """The engine of a serve cell, as `launch/serve.py::serve_once` builds
    it (the resident array, its pins and the paged KV on the CiM path)."""
    from repro_torch.cim.array import resident_ecc_default, resident_set
    from repro_torch.launch import serve as S
    from repro_torch.launch.paged_kv import PagedKV
    from repro_torch.models.model import Model

    slots = int(traffic["slots"])
    max_len = int(traffic["prompt_len"]) + max(traffic["round_gens"])
    cim = traffic["path"] == "cim"
    S.fresh_cim_state()
    model = Model(arch, params=weights)
    spec = rs = None
    if cim:
        spec = S.resident_array_spec(arch, slots, max_len,
                                     ecc=resident_ecc_default())
        rs = resident_set(spec)
        model = model.derive(arch, resident_spec=spec)
    paged = PagedKV.for_model(arch, spec=spec, slots=slots, max_len=max_len,
                              resident_set=rs)
    return S.ServeEngine(model, slots=slots, max_len=max_len,
                         sampler="greedy", cim_lower=cim, paged=paged,
                         warmup_steps=0, seed=0, spec=spec)


def plan_accesses(cfg_file: Dict[str, Any], traffic: Dict[str, Any]
                  ) -> Dict[str, int]:
    """Accesses and dispatches of one CiM decode step by the plan: each
    int contraction over K is one shift-and-add multiply (2 bits - 1
    accesses) and a log2(K padded) tree reduction, one tile each on the
    serve's array; per layer the three MLP products (K = d_model, d_model,
    d_ff) and decode attention's two (K = head_dim, the cache length), one
    dispatch each."""
    bits = int(traffic.get("cim_bits", 8))
    d, f = int(cfg_file["hidden_size"]), int(cfg_file["intermediate_size"])
    hd = d // int(cfg_file["num_attention_heads"])
    t = int(traffic["prompt_len"]) + max(traffic["round_gens"])

    def contraction(k):
        return (2 * bits - 1) + max(0, (k - 1).bit_length())
    layer = sum(contraction(k) for k in (d, d, f, hd, t))
    n = int(cfg_file["num_hidden_layers"])
    return {"accesses": n * layer, "dispatches": n * 5}


def run(cell: Dict[str, Any], cfg_file: Dict[str, Any],
        traffic: Dict[str, Any], seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float,
        calibrate: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One run of a serve cell: set-up, the window, then the check.
    `cell` is the cell's own file (`rounds_per_s`). Returns the record the
    metrics read (see `run.py`)."""
    from repro_torch.cim import accounting, dispatch, fused_kernel
    from repro_torch.launch.serve import ServeRequest

    arch = common.with_serve_mode(common.port_arch(cfg_file), traffic)
    weights = common.make_weights(arch, seed, device, serving=True)
    engine = build_engine(arch, traffic, weights, device)
    n_rounds = max(1, math.ceil(seconds * float(cell.get("rounds_per_s", 0))))
    warm = round_requests(traffic, arch.vocab_size, seed, "warm",
                          gens=traffic["warmup_gens"], rid0=0)
    specs = warm + [s for r in range(n_rounds)
                    for s in round_requests(traffic, arch.vocab_size, seed, r)]
    gens = {s["rid"]: s["gen"] for s in specs}
    warm_left = {s["rid"] for s in warm}
    led = accounting.ledger()
    win: Dict[str, Any] = {}

    def counters():
        return {"fused_bytes": fused_kernel.fused_planes_op.bytes,
                "fused_launches": fused_kernel.fused_planes_op.launches}

    def on_token(ev):
        """Opens the window when the last warm-up request retires, and
        starts the traced span once the window's first decode step is out
        (after the prefills that open the window)."""
        if win:
            if trace and ev["kind"] == "d" and not win.get("traced"):
                win["traced"] = True
                rec.tracer = Tracer(True, float(traffic["trace_seconds"]),
                                    device, counters=counters)
                rec.tracer.start()
            return
        times = token_times(rec.events, gens)
        warm_left.difference_update(
            [rid for rid in list(warm_left)
             if len(times.get(rid, ())) >= gens[rid]])
        if not warm_left:
            win.update(t0=ev["t"], steps=len(rec.step_s),
                       graphs=dispatch.graph_stats(), acc=led.accesses,
                       disp=dispatch.cache_stats()["dispatches"])

    rec = Recorder(engine, device, on_token)
    reqs = [ServeRequest(rid=s["rid"], prompt_len=len(s["prompt"]),
                         gen=s["gen"], prompt=s["prompt"]) for s in specs]
    report = engine.run(reqs)
    t_end = time.perf_counter()
    rec.tracer.stop()
    g1 = dispatch.graph_stats()
    peak = common.device_record(device)

    t0 = win["t0"]
    times = token_times(rec.events, gens)
    window_reqs = [q for q in reqs if q.rid >= ROUND_RIDS]
    record = {
        "window_s": t_end - t0, "setup_s": t0 - t_start, "rounds": n_rounds,
        "output_tokens": sum(1 for ts in times.values() for t in ts if t > t0),
        "prompt_tokens": sum(q.prompt_len for q in window_reqs),
        "attempted": len(window_reqs),
        "completed": sum(1 for q in window_reqs
                         if not q.shed and len(q.tokens) >= q.gen),
        "gaps_ms": [1e3 * (b - a) for ts in times.values()
                    for a, b in zip(ts, ts[1:]) if a > t0],
        "decode_step_ms": [1e3 * s for s in rec.step_s[win["steps"]:]],
        "prefill_ms": [q.prefill_ms for q in window_reqs],
        "step_s": sum(rec.step_s[win["steps"]:])
        + sum(q.prefill_ms for q in window_reqs) / 1e3,
        "ledger_accesses": led.accesses - win["acc"],
        "dispatches": dispatch.cache_stats()["dispatches"] - win["disp"],
        "compiled_in_window": dispatch.compiled(win["graphs"], g1),
        "device": peak, "trace": rec.tracer.summary(),
        "flop_tokens": _flop_tokens(window_reqs),
        "n_active": common.active_params(arch, weights),
        "arch": arch, "cim": traffic["path"] == "cim",
    }
    acc_steps = report["step_accesses"][win["steps"]:]
    disp_steps = report["step_dispatches"][win["steps"]:]

    # the check, once the window has closed and the program's state is
    # freed, judges the tokens of one round drawn from the seed: where a
    # batch's rows are coupled, the reference replays the run from its
    # start through the end of that round; where they are not, it reads
    # each judged request's prompt and served tokens as one sequence
    pick = int(np.random.default_rng(common.sub_seed(seed, "check"))
               .integers(n_rounds))
    judged = {s["rid"] for s in specs if s["round"] == pick}
    last = max(times[rid][-1] for rid in judged)
    coupled = check.rows_coupled(cfg_file, traffic)
    events = [ev for ev in rec.events if ev["t"] <= last] if coupled else []
    served = {q.rid: list(q.tokens) for q in reqs}
    prompts = {s["rid"]: s["prompt"] for s in specs}
    slots, max_len = engine.slots, engine.max_len
    del engine, rec, reqs, report
    _free_program_state()

    precision = f"cim{int(traffic.get('cim_bits', 8))}" \
        if traffic["path"] == "cim" else "float32"
    control = (calibrate or {}).get("control")
    t_ref = time.perf_counter()
    if coupled:
        gaps = check.replay_gaps(cfg_file, weights, events, prompts, served,
                                 gens, slots, max_len, precision, judged,
                                 control=control)
    else:
        gaps = check.sequence_gaps(cfg_file, weights, prompts, served,
                                   judged, precision, control=control)
    record["check"] = "replay" if coupled else "sequences"
    record["reference_s"] = time.perf_counter() - t_ref
    record["check_tokens"] = len(gaps["gaps"])
    record["widest_gap"] = max(gaps["gaps"]) if gaps["gaps"] else None
    record["mean_gap"] = sum(gaps["gaps"]) / max(1, len(gaps["gaps"]))
    record["median_gap"] = common.median(gaps["gaps"])
    record["control_widest_gap"] = gaps.get("control_widest_gap")
    if "control_gaps" in gaps:
        record["control_mean_gap"] = sum(gaps["control_gaps"]) / max(
            1, len(gaps["control_gaps"]))
    if traffic["path"] == "cim":
        plan = plan_accesses(cfg_file, traffic)
        record["plan"] = plan
        record["step_access_gap"] = max(abs(a - plan["accesses"])
                                        for a in acc_steps)
        record["step_dispatch_gap"] = max(abs(a - plan["dispatches"])
                                          for a in disp_steps)
    return record


def _flop_tokens(reqs) -> List[int]:
    """The context each useful token of the window attended over: a
    prompt's positions 1..P in its prefill, then one per output token
    after the first."""
    out: List[int] = []
    for q in reqs:
        p = q.prompt_len
        out.extend(range(1, p + 1))
        out.extend(range(p + 1, p + len(q.tokens)))
    return out


def _free_program_state() -> None:
    """Drop what the program built (programs and their graphs, pins,
    casts, caches) so the reference runs in the memory it leaves."""
    from repro_torch.launch import serve as S

    S.fresh_cim_state()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
