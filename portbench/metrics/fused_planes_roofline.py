"""The fused bit-plane kernel's share of its roofline: the least time its
launches in the traced window could take, their bytes (both plane stacks
read once, every output plane written once: the program's
`fused_planes_op.bytes` counter, held to the benchmark's formula by
`tests/test_portbench_fused_bytes.py`) over the card's HBM bandwidth, over
the kernel's summed device time. The kernel does integer bit operations
only, so bytes bound it. Against the published 3.35 TB/s at 700 W."""
from portbench.harness.trace import kernel_seconds

UNIT = "%"
LAYER = "kernels"
MOVES = "output_tok_s"


def read(rec):
    tr, peaks = rec.get("trace"), rec.get("peaks")
    if not rec.get("cim") or not tr or not peaks:
        return None
    t = kernel_seconds(tr, "fused_planes_kernel")
    nbytes = tr["counters"].get("fused_bytes", 0)
    if t <= 0 or nbytes <= 0:
        return None
    return 100.0 * (nbytes / peaks["hbm_bytes_s"]) / t
