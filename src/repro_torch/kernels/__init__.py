"""Kernels of the model families, with their plain PyTorch versions.

Port of `repro.kernels` as far as the serve and train paths reach it:
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
  ops   — `attention`, `rglru_scan`, `slstm_scan`: the plain version for
          CPU tensors, the kernel for CUDA tensors.
"""
