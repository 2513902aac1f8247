"""Kernels of the model families, with their plain PyTorch versions.

Port of `repro.kernels` as far as the serve paths reach it:
  rglru — the RG-LRU recurrence, CUDA C++ for sm_90a (`csrc/rglru.cu`);
  ref   — the plain versions the tests and `chip_smoke.py` hold it to;
  ops   — `rglru_scan`: the plain version for CPU tensors, the kernel for
          CUDA tensors.
Flash attention and sLSTM wait (ROADMAP B2, B4).
"""
