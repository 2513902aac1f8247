"""repro_torch.cim — the ADRA CiM engine, ported to PyTorch and CUDA.

  opset        — the op catalogue and plane-level Boolean composition
  planepack    — PlanePack: packed planes + metadata, packed-domain wiring,
                 the SECDED codec across the plane index
  fused_kernel — the fused single-pass kernel (CUDA, sm_90a) and its plain
                 PyTorch version
  backends     — registry: fused / torch-boolean / analog-oracle (the
                 FeFET device model per bit), set_default_backend
  engine       — execute / execute_unfused, the integer-level add, sub,
                 compare and boolean wrappers, the traffic model
  accounting   — the access ledger: per-(device, bank) activations,
                 inter-bank reduction words, the contention-adjusted bank
                 report and the energy projection
  array        — ArraySpec (banks x subarrays x rows x bitline words, dead
                 banks), TilePlan placement, ResidentSet (pinned operands,
                 SECDED-protected with ecc), the process-wide spec override
  faults       — seeded fault injection (streamed BER, resident BER,
                 retention decay, stuck-at rows, bank kills), its counters
                 and the training side's host-failure hook
  dispatch     — the tiling dispatcher (`execute_tiled`), the bounded
                 program cache and dispatch counters
  planner      — access Schedules for every macro, region concatenation,
                 the schedule traffic model
  macro        — schedule executors: multiply, abs/relu/min/max, popcount,
                 reduce_sum, dot/matmul/batched matmul (resident rhs too),
                 each one dispatch, unbanked or placed on a banked spec;
                 ChainExecutor for fused regions
  trace        — aten capture (make_fx on fake tensors) and the per-node
                 eligibility classification, with the `int_contract` and
                 `population_count` ops it reads as one node each
  cost         — spec-driven cost model: DeviceSpec host roofline (an H100
                 SXM row by default) vs CiM energy/latency/EDP per op, and
                 the offload policy that decides whether lowering pays
  autotune     — geometry/bits autotuner: cost-model-pruned, walltime-
                 confirmed search with a bounded, JSON-persisted winners table
  lower        — the lowering compiler: fuse eligible node runs into region
                 Schedules, run each as one dispatch through ChainExecutor,
                 run the rest on the host
"""
from . import (  # noqa: F401
    accounting,
    autotune,
    array,
    backends,
    cost,
    dispatch,
    engine,
    faults,
    fused_kernel,
    lower as lower_mod,
    macro,
    opset,
    planner,
    trace as trace_mod,
)
from .accounting import LEDGER, Ledger, ledger, project_savings  # noqa: F401
from .array import (  # noqa: F401
    DEFAULT_SPEC,
    ArraySpec,
    ResidentSet,
    TilePlan,
    clear_resident,
    current_spec,
    resident_set,
    resident_stats,
    set_current_spec,
    set_resident_ecc,
)
from .autotune import Autotuner, Candidate, TuneResult  # noqa: F401
from .faults import (  # noqa: F401
    FaultConfig,
    FaultModel,
    UncorrectableFaultError,
    fault_seed,
    fault_stats,
)
from .cost import (  # noqa: F401
    DEFAULT_DEVICE,
    DEFAULT_POLICY,
    POLICIES,
    DeviceSpec,
    EqnVerdict,
    OffloadPlan,
    cim_wins_table,
    plan_offload,
)
from .backends import (  # noqa: F401
    available_backends,
    default_backend_name,
    get_backend,
    register_backend,
    set_default_backend,
)
from .dispatch import (  # noqa: F401
    BoundedLRU,
    cache_stats,
    clear_schedule_cache,
    execute_sharded,
    execute_tiled,
    set_schedule_cache_capacity,
)
from .engine import (  # noqa: F401
    CmpOut,
    add,
    boolean,
    compare,
    execute,
    execute_unfused,
    measured_traffic_bytes,
    sub,
    traffic_model_bytes,
)
from .fused_kernel import fused_planes_op  # noqa: F401
from .lower import (  # noqa: F401
    LoweredComputation,
    LoweredFunction,
    lower,
)
from .trace import Trace, TracedOp, trace  # noqa: F401
from .macro import (  # noqa: F401
    ChainExecutor,
    CompiledSchedule,
    ScheduleCursor,
    abs_,
    dot,
    matmul,
    matmul_rhs_pack,
    maximum,
    minimum,
    multiply,
    popcount,
    reduce_sum,
    relu,
    run_schedule_program,
    select,
)
from .opset import (  # noqa: F401
    ALL_OPS,
    ARITH_OPS,
    BOOLEAN_OPS,
    PREDICATE_OPS,
    CimOpError,
)
from .planepack import PlanePack, mask_to_ints  # noqa: F401
from .planner import (  # noqa: F401
    Schedule,
    Step,
    concat_schedules,
    plan_abs,
    plan_dot,
    plan_elementwise,
    plan_matmul,
    plan_maximum,
    plan_minimum,
    plan_multiply,
    plan_neg,
    plan_popcount,
    plan_reduce_sum,
    plan_relu,
    schedule_traffic_bytes,
)
