"""Program dispatches per output token: the change of
`dispatch.cache_stats()["dispatches"]` (cached schedule programs invoked,
each one graph replay when warm) over the window's output tokens."""
UNIT = "dispatches/token"
LAYER = "program graphs"
MOVES = "output_tok_s"


def read(rec):
    if not rec.get("cim") or not rec.get("output_tokens"):
        return None
    return rec["dispatches"] / rec["output_tokens"]
