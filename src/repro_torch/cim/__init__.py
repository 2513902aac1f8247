"""repro_torch.cim — the ADRA CiM engine, ported to PyTorch and CUDA.

  opset        — the op catalogue and plane-level Boolean composition
  planepack    — PlanePack: packed planes + metadata, packed-domain wiring
  fused_kernel — the fused single-pass kernel (CUDA, sm_90a) and its plain
                 PyTorch version
  backends     — registry: fused / torch-boolean
  engine       — execute / execute_traced + the traffic model
  accounting   — the access ledger and its energy projection
  array        — ArraySpec, TilePlan, ResidentSet (pinned operands)
  dispatch     — the bounded program cache and dispatch counters
  planner      — access Schedules for multiply, reduce, matmul
  macro        — schedule executors: matmul / batched matmul, resident rhs
"""
from . import (  # noqa: F401
    accounting,
    array,
    backends,
    dispatch,
    engine,
    fused_kernel,
    macro,
    opset,
    planner,
)
from .accounting import LEDGER, Ledger, ledger, project_savings  # noqa: F401
from .array import (  # noqa: F401
    DEFAULT_SPEC,
    ArraySpec,
    ResidentSet,
    TilePlan,
    clear_resident,
    resident_set,
    resident_stats,
)
from .dispatch import cache_stats, clear_schedule_cache  # noqa: F401
from .planepack import PlanePack  # noqa: F401
