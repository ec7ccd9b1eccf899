"""Device resolution shared by every entry point of the port.

Entry points run on the GPU unless the caller asks for the CPU: `device`
None means "cuda", and asking for CUDA on a host without a GPU raises
instead of carrying on quietly on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """torch.device for an entry point's `device` argument (None = cuda).

    Raises:
        RuntimeError: CUDA was requested (explicitly or by default) and
            `torch.cuda.is_available()` is False.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the host")
    return dev
