"""The dd (2-plane) binding of kernel #1, ``kernels/mlgemm.py``.

The port of ``repro.kernels.ddgemm``.  On a CUDA tensor this is the
hand-written Hopper kernel ``csrc/mlgemm.cu``.
"""

from __future__ import annotations

from ..gemm.plan import DEFAULT_BLOCKS  # noqa: F401  (canonical home)
from .mlgemm import mlgemm_kernel_call

__all__ = ["ddgemm_kernel_call", "DEFAULT_BLOCKS"]

# raw kernel invocation on dd limbs: (a_hi, a_lo, b_hi, b_lo) -> [c_hi, c_lo]
ddgemm_kernel_call = mlgemm_kernel_call
