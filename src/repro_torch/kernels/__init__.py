"""Kernels of the model families, with their plain PyTorch versions.

Port of `repro.kernels`:
  adra_bitplane — the legacy select-based shims over the fused bit-plane
          kernel (`repro_torch.cim.fused_kernel`, CUDA C++ for sm_90a),
          which emits any subset of the CiM op catalogue from one pass;
  flash_attention — GQA attention forward, CUDA C++ for sm_90a: bf16 on
          the tensor cores (`csrc/flash_attention_sm90.cu`, TMA and
          wgmma), float32 and the rest on `csrc/flash_attention.cu`
          (SIMT), picked by `flash_attention.route`;
  rglru — the RG-LRU recurrence, CUDA C++ for sm_90a: channel tiles
          streamed through shared memory by TMA (`csrc/rglru_sm90.cu`) for
          prefill, one thread per channel (`csrc/rglru.cu`) for decode and
          short T, picked by `rglru.route`;
  slstm — the sLSTM recurrence, CUDA C++ for sm_90a: a persistent grid
          with R in shared memory (`csrc/slstm_sm90.cu`) where its slices
          fit, one block per batch row (`csrc/slstm.cu`) for the rest,
          picked by `slstm.route`;
  ref   — the plain versions the tests and `chip_smoke.py` hold them to;
  ops   — `adra_sub`, `adra_add`, `baseline_sub_then_cmp`, `cim_matmul`,
          `cim_relu`, `cim_lower` through the CiM engine, and `attention`,
          `rglru_scan`, `slstm_scan`: the plain version for CPU tensors,
          the kernel for CUDA tensors.
"""
# the reference also re-exports its flash_attention and rglru functions
# here; the port's modules of those names stay reachable as modules
# (`from repro_torch.kernels import rglru` is the module, with its route
# and launch counters), so their functions are reached through `ops`
from . import ops, ref  # noqa: F401
from .adra_bitplane import adra_bitplane_op, traffic_model_bytes  # noqa: F401
from .ops import slstm_scan  # noqa: F401
