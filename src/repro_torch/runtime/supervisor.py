"""Training supervisor: the fault-tolerance control loop.

Port of `repro.runtime.supervisor`:
  * periodic async checkpointing
  * NaN sentinel: a non-finite loss triggers restore-from-last-checkpoint
  * simulated host failure (exceptions from the step fn): restore + resume;
    restart-exact data means the recovered run equals an uninterrupted one
  * straggler detection: per-step wall-time EWMA against the fleet median
    (one host here; the detector takes any number)

A restore writes the checkpoint into the live state's tensors
(`CheckpointManager.restore`), so a step program that took the state as a
donated leaf (`launch/train.py`: one CUDA graph a step on one card) goes
on replaying on the same tensors; re-placing a checkpoint on another mesh
is `runtime/elastic.py`'s `restore_on_mesh`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointManager


class SimulatedHostFailure(RuntimeError):
    """Raised by fault-injection hooks to emulate a node loss."""


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 8
    straggler_factor: float = 2.0
    ewma_alpha: float = 0.2


class StragglerDetector:
    """Per-host step-time EWMA vs the fleet median."""

    def __init__(self, n_hosts: int, cfg: SupervisorConfig):
        self.cfg = cfg
        self.ewma = np.zeros(n_hosts)
        self.seen = np.zeros(n_hosts, dtype=bool)

    def update(self, host_times: np.ndarray) -> List[int]:
        a = self.cfg.ewma_alpha
        self.ewma = np.where(self.seen, (1 - a) * self.ewma + a * host_times,
                             host_times)
        self.seen[:] = True
        med = float(np.median(self.ewma))
        return [int(i) for i in
                np.nonzero(self.ewma > self.cfg.straggler_factor * med)[0]]


class Supervisor:
    def __init__(
        self,
        train_step: Callable,
        make_batch: Callable[[int], Any],
        ckpt: CheckpointManager,
        cfg: SupervisorConfig = SupervisorConfig(),
        fault_hook: Optional[Callable[[int], None]] = None,
        n_hosts: int = 1,
    ):
        self.train_step = train_step
        self.make_batch = make_batch
        self.ckpt = ckpt
        self.cfg = cfg
        self.fault_hook = fault_hook
        self.straggler = StragglerDetector(n_hosts, cfg)
        self.events: List[Dict[str, Any]] = []

    def _restore(self, state):
        step = self.ckpt.latest_step()
        if step is None:
            return state, 0
        restored = self.ckpt.restore(step, state)
        return restored, int(step)

    def run(self, state, n_steps: int):
        """Run to n_steps with restart-on-failure. Returns (state, metrics)."""
        restarts = 0
        step = int(state["step"])
        last_metrics: Dict[str, Any] = {}
        while step < n_steps:
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                batch = self.make_batch(step)
                t0 = time.monotonic()
                state, metrics = self.train_step(state, batch)
                loss = float(metrics["loss"])
                dt = time.monotonic() - t0
                stragglers = self.straggler.update(np.array([dt]))
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {step}")
                step += 1
                last_metrics = {**metrics, "stragglers": stragglers}
                if step % self.cfg.ckpt_every == 0:
                    self.ckpt.save(step, state, blocking=False)
            except (SimulatedHostFailure, FloatingPointError) as e:
                restarts += 1
                self.events.append({"step": step, "error": repr(e),
                                    "restart": restarts})
                if restarts > self.cfg.max_restarts:
                    raise RuntimeError(f"exceeded max_restarts: {e}") from e
                self.ckpt.wait()
                state, step = self._restore(state)
        self.ckpt.wait()
        return state, last_metrics
