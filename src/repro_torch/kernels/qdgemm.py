"""The qd (4-plane) binding of kernel #1, ``kernels/mlgemm.py``.

The port of ``repro.kernels.qdgemm``.  On a CUDA tensor this is the
hand-written Hopper kernel ``csrc/mlgemm.cu`` built at four limbs.
"""

from __future__ import annotations

from .mlgemm import mlgemm_kernel_call

__all__ = ["qdgemm_kernel_call"]

# raw kernel invocation on qd limbs: (a0..a3, b0..b3) -> [c0..c3]
qdgemm_kernel_call = mlgemm_kernel_call
