"""Share of the traced window's device busy time in dtype conversions:
the copy kernels that cast (`direct_copy_kernel` through a casting loop,
`bfloat16_copy_kernel`, `float16_copy_kernel`), the bf16 weights' upcasts
to float32 among them. Same-dtype copies (the `nocast` copy loop, memcpy)
are `copy_share`'s. Profiler."""
UNIT = "%"
LAYER = "float model"
MOVES = "output_tok_s"


def is_cast(name: str) -> bool:
    return "copy_kernel" in name and "nocast" not in name


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    t = sum(v for n, v in tr["kernels"].items() if is_cast(n))
    return 100.0 * t / tr["busy_s"]
