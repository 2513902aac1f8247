"""Step factories of the port."""
from .step import greedy_sample, make_decode_step, make_prefill_step  # noqa: F401
