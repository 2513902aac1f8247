"""Mean of the window's prefills, as the engine times each (`prefill_ms`:
the prefill call to its synchronise)."""
UNIT = "ms"
LAYER = "serve engine"
MOVES = "output_tok_s"


def read(rec):
    xs = rec.get("prefill_ms", [])
    return sum(xs) / len(xs) if xs else None
