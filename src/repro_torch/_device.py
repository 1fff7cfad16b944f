"""Device policy shared by every entry point of the port.

Functions that take tensors run where their operands live and refuse a
mix of devices.  Functions that make data from numpy or from nothing take
``device=None``, which means the CUDA card: without one they raise rather
than carry on quietly on the CPU (tests pass ``device="cpu"``).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "common_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is absent instead of falling
    back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def common_device(*tensors) -> torch.device:
    """The one device all ``tensors`` share (``None`` entries skipped).

    torch itself lets a 0-dim CPU tensor ride along with CUDA operands, so
    the port checks explicitly.
    """
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"operands must share one device, got "
                         f"{sorted(str(d) for d in devs)}")
    return devs.pop()
