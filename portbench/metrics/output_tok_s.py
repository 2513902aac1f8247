"""Output tokens per second: every token that every request of the window
produced (the first, from its prefill, included), over the whole window,
prefills, admissions and drains included. Host clock."""
UNIT = "tokens/s"
LAYER = None
MOVES = None


def read(rec):
    if "output_tokens" not in rec:
        return None
    return rec["output_tokens"] / rec["window_s"]
