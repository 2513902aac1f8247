"""Share of the traced window's device busy time in same-dtype copies:
the `nocast` copy loop and memory copies (graph inputs copied into a
replayed graph's static tensors, outputs cloned, strided copies). Casts
are `cast_share`'s. Profiler."""
UNIT = "%"
LAYER = "program graphs"
MOVES = "output_tok_s"


def is_copy(name: str) -> bool:
    low = name.lower()
    return ("copy_kernel" in name and "nocast" in name) \
        or low.startswith("memcpy")


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    t = sum(v for n, v in tr["kernels"].items() if is_copy(n))
    return 100.0 * t / tr["busy_s"]
