"""Share of the traced window's device busy time spent in every device
operation but the fused bit-plane kernel: the packed-domain glue around it
(packing, shifts, casts, copies). Profiler."""
from portbench.harness.trace import kernel_seconds

UNIT = "%"
LAYER = "packed-domain glue"
MOVES = "output_tok_s"


def read(rec):
    tr = rec.get("trace")
    if not rec.get("cim") or not tr or tr["busy_s"] <= 0:
        return None
    fused = kernel_seconds(tr, "fused_planes_kernel")
    total = sum(tr["kernels"].values())
    return 100.0 * (total - fused) / tr["busy_s"]
