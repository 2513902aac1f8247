"""The whole serve step's share of the card's bf16 peak: the model FLOPs
of every useful token of the window (prompt tokens in their prefill and
output tokens after the first: 2 x active parameters each, plus the
attention's 2 x context x heads x (key width + value width) a layer), over
the seconds of the window's prefill and decode calls, each timed to its
synchronise, x 989 TFLOP/s (published, 700 W). Rows of idle slots are not
useful work and are not counted. The calls' seconds, not the window's:
in the traced run the profiler's stop pauses the window between two
steps."""
UNIT = "%"
LAYER = "whole step"
MOVES = "output_tok_s"


def attention_flops_per_ctx(arch) -> float:
    """2 x heads x (qk width + v width) x layers: one token's attention
    FLOPs per position of context."""
    if arch.mla is not None:
        qk = arch.mla.qk_nope_dim + arch.mla.qk_rope_dim
        v = arch.mla.v_head_dim
    else:
        qk = v = arch.head_dim
    return 2.0 * arch.n_heads * (qk + v) * arch.n_layers


def read(rec):
    peaks = rec.get("peaks")
    if not peaks or "flop_tokens" not in rec:
        return None
    ctx = rec["flop_tokens"]
    flops = 2.0 * rec["n_active"] * len(ctx) \
        + attention_flops_per_ctx(rec["arch"]) * sum(ctx)
    return 100.0 * flops / (rec["step_s"] * peaks["bf16_flops"])
