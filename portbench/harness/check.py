"""The comparison that decides `correct` in the serve cells.

The plain reference (`portbench/reference/<name>.py`, named by the
configuration file) computes the logits at every position where the
program served a token of a judged request; the gap there is how far the
served token's logit lies below the reference's best logit, and the
number compared is the widest gap (or the mean, where a cell's limits say
so).

How the reference reaches those positions depends on whether the program
couples the rows of a batch (`rows_coupled`):
- coupled (the CiM path's per-tensor scales over a decode step's rows, a
  MoE capacity that can drop choices): it replays the engine's run event
  by event from its start, each prefill into its slot and each decode step
  over all slots, fed the tokens and positions the engine fed;
- not coupled: a request's tokens depend on its own prompt and tokens
  alone, so it reads each judged request's prompt and served tokens as one
  sequence (`sequence_gaps`).

With `control`, a second reference in that lower precision runs the same
way beside it, and at each of the same positions the gap of the token the
control ranks first is read by the reference: the control's gap must fail
the limit that the program's passes.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional

import torch


def _reference(cfg_file: Dict[str, Any]):
    return importlib.import_module(
        f"portbench.reference.{cfg_file['reference']}")


def rows_coupled(cfg_file: Dict[str, Any], traffic: Dict[str, Any]) -> bool:
    """Whether the program's answer for one row of a batch depends on the
    other rows: on the CiM path (a contraction's scale is its whole
    operand's), or where a MoE capacity can drop a choice (capacity factor
    x top_k below the experts: a call's tokens compete for places)."""
    if traffic["path"] == "cim":
        return True
    if "n_routed_experts" not in cfg_file:
        return False
    return float(cfg_file["capacity_factor"]) \
        * int(cfg_file["num_experts_per_tok"]) < int(cfg_file["n_routed_experts"])


def sequence_gaps(cfg_file: Dict[str, Any], weights,
                  prompts: Dict[int, List[int]], served: Dict[int, List[int]],
                  judged, precision: str, control: Optional[str] = None
                  ) -> Dict[str, Any]:
    """Judge each request in `judged` by one pass of the reference over its
    prompt and its served tokens but the last: the states at positions
    P - 1 onwards give the logits of its served tokens."""
    rids = sorted(judged)
    seqs = {rid: list(prompts[rid]) + list(served[rid][:-1]) for rid in rids}
    events = [{"kind": "p", "rid": rid, "slot": i}
              for i, rid in enumerate(rids)]
    max_len = max(len(q) for q in seqs.values())
    ref_mod = _reference(cfg_file)
    tok = [t for rid in rids for t in served[rid]]

    def logits(prec):
        dec = ref_mod.reference_for(cfg_file, weights, len(rids), max_len,
                                    prec)
        hs = dec.replay(events, seqs, every_position=True)
        rows = torch.cat([h[len(prompts[rid]) - 1:]
                          for h, rid in zip(hs, rids)])
        if getattr(dec, "dropped", 0):
            raise RuntimeError(f"the reference's MoE dropped {dec.dropped} "
                               f"choices: the rows are coupled")
        return dec.logits(rows)
    return _gaps(logits, tok, precision, control)


def _gaps(logits, served_tokens: List[int], precision: str,
          control: Optional[str]) -> Dict[str, Any]:
    """Gaps of the served tokens under the reference's logits (`logits`:
    precision -> [N, vocab]), and of the control's first choices."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lg = logits(precision)
    tok = torch.tensor(served_tokens, device=lg.device)
    best = lg.max(dim=-1).values
    out: Dict[str, Any] = {
        "gaps": (best - lg.gather(1, tok[:, None])[:, 0]).tolist()}
    if control:
        pick = logits(control).argmax(dim=-1)
        ctl_gaps = (best - lg.gather(1, pick[:, None])[:, 0]).tolist()
        out["control_gaps"] = ctl_gaps
        out["control_widest_gap"] = max(ctl_gaps) if ctl_gaps else None
    return out


def replay_gaps(cfg_file: Dict[str, Any], weights, events: List[Dict[str, Any]],
                prompts: Dict[int, List[int]], served: Dict[int, List[int]],
                gens: Dict[int, int], slots: int, max_len: int,
                precision: str, judged, control: Optional[str] = None
                ) -> Dict[str, Any]:
    """Replay `events` (every one from the run's start) and judge the
    tokens of the requests in `judged`."""
    ref_mod = _reference(cfg_file)
    # (event, row, served token) of every judged token
    judged_at = []
    active: Dict[int, List[int]] = {}          # slot -> [rid, next index]
    for e, ev in enumerate(events):
        if ev["kind"] == "p":
            rid, slot = ev["rid"], ev["slot"]
            if rid in judged:
                judged_at.append((e, 0, served[rid][0]))
            if gens[rid] > 1:
                active[slot] = [rid, 1]
            continue
        for slot, st in list(active.items()):
            rid, i = st
            if rid in judged:
                judged_at.append((e, slot, served[rid][i]))
            st[1] += 1
            if st[1] >= gens[rid]:
                del active[slot]

    def logits(prec):
        dec = ref_mod.reference_for(cfg_file, weights, slots, max_len, prec)
        hs = dec.replay(events, prompts)
        return dec.logits(torch.stack([hs[e][r] for e, r, _ in judged_at]))
    return _gaps(logits, [t for _, _, t in judged_at], precision, control)
