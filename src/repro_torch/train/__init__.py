"""Step factories of the port."""
from .step import (adra_sample, adra_sample_ref,  # noqa: F401
                   greedy_sample, init_state, make_decode_step,
                   make_eval_step, make_prefill_step, make_train_step)
