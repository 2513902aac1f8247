"""Tiny configurations and traffic for the CPU tests: the two families the
harness and its reference serve (dense GQA SwiGLU; MLA with routed and
shared experts) at a few dozen features, in the same file layout."""
import copy

DENSE = {
    "name": "tiny-dense", "hidden_size": 64, "intermediate_size": 128,
    "num_attention_heads": 4, "num_key_value_heads": 2,
    "num_hidden_layers": 2, "vocab_size": 250, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-06, "tie_word_embeddings": False,
    "reference": "decoder",
    "port": {"name": "tiny-dense", "family": "dense", "n_layers": 2,
             "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
             "d_ff": 128, "vocab_size": 250, "gating": "swiglu",
             "rope_theta": 10000.0, "norm_eps": 1e-06,
             "tie_embeddings": False, "dtype": "bfloat16",
             "param_dtype": "float32", "remat": False, "microbatches": 1},
    "port_keys": {"n_layers": "num_hidden_layers", "d_model": "hidden_size",
                  "d_ff": "intermediate_size", "vocab_size": "vocab_size"},
}

MOE = {
    "name": "tiny-moe", "hidden_size": 64, "intermediate_size": 96,
    "num_attention_heads": 4, "num_key_value_heads": 4,
    "num_hidden_layers": 3, "vocab_size": 250, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-06, "tie_word_embeddings": False,
    "first_k_dense_replace": 1, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
    "qk_rope_head_dim": 8, "v_head_dim": 16, "n_routed_experts": 8,
    "num_experts_per_tok": 3, "n_shared_experts": 1,
    "moe_intermediate_size": 32, "norm_topk_prob": True,
    "capacity_factor": 1.25, "reference": "decoder",
    "port": {"name": "tiny-moe", "family": "moe", "n_layers": 3,
             "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 16,
             "d_ff": 32, "vocab_size": 250, "rope_theta": 10000.0,
             "norm_eps": 1e-06, "tie_embeddings": False,
             "dtype": "bfloat16", "param_dtype": "float32", "remat": False,
             "first_dense_layers": 1, "d_ff_first_dense": 96,
             "microbatches": 1,
             "moe": {"n_experts": 8, "top_k": 3, "d_ff_expert": 32,
                     "n_shared": 1, "capacity_factor": 1.25,
                     "router_renorm": True},
             "mla": {"kv_lora_rank": 32, "qk_nope_dim": 16,
                     "qk_rope_dim": 8, "v_head_dim": 16}},
    "port_keys": {"moe.n_experts": "n_routed_experts",
                  "mla.kv_lora_rank": "kv_lora_rank"},
}

CIM = {"kind": "serve", "path": "cim", "slots": 2, "prompt_len": 4,
       "round_gens": [2, 4], "warmup_gens": [3, 3], "cim_bits": 8,
       "trace_seconds": 0.5}
FLOAT = {"kind": "serve", "path": "float", "slots": 3, "prompt_len": 6,
         "round_gens": [2, 3, 5, 4], "warmup_gens": [3, 3, 3],
         "trace_seconds": 0.5}


def get(name):
    return copy.deepcopy({"dense": DENSE, "moe": MOE, "cim": CIM,
                          "float": FLOAT}[name])


def dropless_moe():
    """The tiny MoE with a capacity no call can overflow (factor x top_k
    >= experts), as a dropless published MoE is: nothing couples a batch's
    rows."""
    cfg = get("moe")
    cfg["capacity_factor"] = cfg["port"]["moe"]["capacity_factor"] = 3.0
    return cfg
