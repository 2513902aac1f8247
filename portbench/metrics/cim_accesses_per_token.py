"""CiM compute accesses per output token: the change of the port's ledger
(`accounting.ledger().accesses`) over the window, prefills included, over
the window's output tokens. Exact and fixed by the plan."""
UNIT = "accesses/token"
LAYER = "lowering + CiM schedules"
MOVES = "output_tok_s"


def read(rec):
    if not rec.get("cim") or not rec.get("output_tokens"):
        return None
    return rec["ledger_accesses"] / rec["output_tokens"]
