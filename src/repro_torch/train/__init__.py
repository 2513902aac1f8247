"""Step factories of the port."""
from .step import (greedy_sample, init_state, make_decode_step,  # noqa: F401
                   make_eval_step, make_prefill_step, make_train_step)
