"""Plain-torch oracles for the extended-precision GEMM kernels.

The port of ``repro.kernels.ref``: ``mlgemm_ref`` is the count-generic
exact-product + compensated-halving-tree matmul over ``core.mp``, and
``ddgemm_ref``/``tdgemm_ref``/``qdgemm_ref`` its tier bindings.  Memory
O(m*k*n): test sizes only.
"""

from __future__ import annotations

import torch

from ..core import mp

__all__ = ["mlgemm_ref", "ddgemm_ref", "tdgemm_ref", "qdgemm_ref",
           "gemm_f64_ref"]


def mlgemm_ref(a, b):
    """C = A @ B at the operands' tier: exact per-element products,
    compensated halving-tree accumulation over k (leading batch dims
    broadcast)."""
    k, k2 = a.shape[-1], b.shape[-2]
    if k != k2:
        raise ValueError(f"inner dims mismatch: {a.shape} x {b.shape}")
    abig = mp.map_limbs(lambda l: l[..., :, :, None], a)  # (..., m, k, 1)
    bbig = mp.map_limbs(lambda l: l[..., None, :, :], b)  # (..., 1, k, n)
    return mp.sum_(mp.mul(abig, bbig), axis=-2)


# the tier bindings of the reference: one count-generic oracle serves all
ddgemm_ref = tdgemm_ref = qdgemm_ref = mlgemm_ref


def gemm_f64_ref(a, b):
    """Plain f64 matmul — the 'double' baseline the paper compares against."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64))
