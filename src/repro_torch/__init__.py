"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

Same subpackage layout as ``src/repro`` (configs, core, kernels, models,
serve).  Plain tensor code is PyTorch; every contraction on the serving path
goes through ``repro_torch.kernels.ops``, which sends a CUDA tensor to a
hand-written CUDA kernel (built from ``kernels/csrc`` at first use) and a CPU
tensor to the kernel's plain PyTorch version.

Importing the package imports no kernel, builds nothing and touches no GPU.
"""
from __future__ import annotations

__version__ = "0.1.0"

__all__ = ["__version__", "resolve_device"]


def resolve_device(device=None):
    """The device an entry point runs on: CUDA unless the caller names
    another.  Without a GPU and without ``device`` this raises, so nothing
    falls back to the CPU silently."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    return torch.device("cuda")
