"""repro_torch — the PyTorch/CUDA port of `repro` (ADRA computing-in-memory).

The package mirrors `repro` module for module (`repro_torch.cim.planner`
<-> `repro.cim.planner`), imports torch and numpy and never jax or `repro`,
and grows slice by slice; the JAX package stays the reference it is held
against. Plane stacks are `torch.int32` tensors holding the uint32 bit
pattern (PyTorch's CPU build lacks `~`, `<<` and `>>` on `torch.uint32`).

Entry points run on `cuda` unless the caller passes `device="cpu"`; asking
for `cuda` without a GPU raises. The kernels — the fused bit-plane access
(`repro_torch.cim.fused_kernel`), the RG-LRU and sLSTM recurrences and
flash attention (`repro_torch.kernels`) — are CUDA C++ for sm_90a, built
at first use into `build/repro_torch_kernels/`. The serve entry point is
`repro_torch.launch.serve`, the train entry point `repro_torch.launch.train`.
"""
import torch

#: devices whose tensors take a kernel's plain PyTorch version: the CPU
#: (tests, rehearsals) and `meta` (the dry run's tensors, shapes and dtypes
#: only). A CUDA tensor is never among them: it launches its kernel or
#: raises.
PLAIN_DEVICES = ("cpu", "meta")


def takes_plain(t: torch.Tensor) -> bool:
    """Whether `t` takes a kernel's plain version (`PLAIN_DEVICES`)."""
    return t.device.type in PLAIN_DEVICES


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` by default; raises when
    CUDA is asked for and absent instead of carrying on on the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev
