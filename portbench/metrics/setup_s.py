"""Seconds from the process's start to the first timed call: imports, the
weights made on the card, the model built, pins, warm-up and captures (and,
in a checkout's first run, the kernel builds). Host clock."""
UNIT = "s"
LAYER = None
MOVES = None


def read(rec):
    return rec["setup_s"]
