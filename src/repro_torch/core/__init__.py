"""repro_torch.core — the paper's contribution: ADRA digital computing-in-memory.

Port of `repro.core`, exporting what it exports. Layers:
  fefet          — HZO FeFET device model (Miller's equations)
  array          — asymmetric dual-row senseline model (the ADRA mechanism)
  sensing        — 3-SA reference scheme + OAI recovery of A
  compute_module — gate-level add/sub/compare peripheral (Fig 3d)
  bitplane       — int <-> bit-plane codecs
  adra           — the ops on tensors: cim_add / cim_sub / cim_compare /
                   cim_boolean / cim_add_sub (analog-validated and boolean
                   paths)
  energy         — calibrated energy/latency/EDP model (Figs 4-7)
  offload        — ADRA offload estimator over the lowering compiler's
                   capture, and a scan of HLO text
"""
from .adra import (  # noqa: F401
    AccessOutputs,
    ArithOut,
    CmpOut,
    adra_access,
    cim_add,
    cim_boolean,
    cim_compare,
    cim_sub,
    BOOLEAN_FUNCTIONS,
)
from .array import AdraArrayConfig, level_currents, senseline_current  # noqa: F401
from .compute_module import compare_from_sub, compute_module, ripple_chain  # noqa: F401
from .energy import (  # noqa: F401
    current_sensing,
    edp_summary,
    frequency_crossover_hz,
    parallelism_crossover,
    voltage_scheme1,
    voltage_scheme2,
)
from .fefet import BiasConditions, FeFETParams, FEParams  # noqa: F401
from .offload import OffloadReport, analyze, analyze_hlo, analyze_trace  # noqa: F401
from .sensing import SenseReferences, current_sense_margins, voltage_sense_margins  # noqa: F401
