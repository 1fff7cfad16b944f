"""Rgemm-compatible BLAS layer (paper §III-A, Listing 1).

The port of ``repro.core.blas``.  ``rgemm`` does the transposes on the
host side of MPLAPACK's split and hands the O(mnk) product AND the
alpha/beta epilogue to the engine, which fuses the epilogue into kernel
#2's drain on the ``ozaki-pallas`` backend and applies the identical tier
arithmetic as a post-step everywhere else.
"""

from __future__ import annotations

import torch

from ..gemm import matmul
from . import mp

__all__ = ["rgemm", "rsyrk", "transpose", "identity", "rlange"]


def transpose(a):
    """Swap the matrix axes of every limb (a view, not a copy)."""
    return mp.map_limbs(lambda l: torch.swapaxes(l, -1, -2), a)


def identity(n: int, dtype=torch.float64, precision: str = "dd",
             device=None):
    """The n x n identity at a tier (``device=None`` -> CUDA)."""
    from .._device import resolve_device

    return mp.from_float(torch.eye(n, dtype=dtype,
                                   device=resolve_device(device)), precision)


def rlange(norm: str, a):
    """Matrix norm of a multi-limb value (MPLAPACK's Rlange), as an f64
    0-dim tensor: ``'m'`` max |a_ij|, ``'1'`` max column sum, ``'i'`` max
    row sum.  Sums accumulate in the value's own tier."""
    kind = norm.lower()
    if kind == "m":
        return mp.max_abs(a)
    if kind not in ("1", "i", "inf"):
        raise ValueError(f"unknown norm {norm!r}; one of 'm', '1', 'i'")
    axis = -2 if kind == "1" else -1
    sums = mp.sum_(mp.abs_(a), axis=axis)
    return torch.max(mp.limbs(sums)[0])


def rgemm(transa: str, transb: str, alpha, a, b, beta,
          c=None, *, plan=None, **plan_overrides):
    """C = alpha * op(A) @ op(B) + beta * C   (op per 'n'/'t' flags)."""
    if transa.lower().startswith("t"):
        a = transpose(a)
    if transb.lower().startswith("t"):
        b = transpose(b)
    return matmul(a, b, plan=plan, alpha=alpha, beta=beta, c=c,
                  **plan_overrides)


def rsyrk(uplo: str, trans: str, alpha, a, beta, c=None, **kwargs):
    """C = alpha * A @ A^T + beta * C (the full symmetric result; uplo is
    kept for API compatibility)."""
    del uplo
    at = transpose(a)
    if trans.lower().startswith("t"):
        return rgemm("n", "n", alpha, at, a, beta, c, **kwargs)
    return rgemm("n", "n", alpha, a, at, beta, c, **kwargs)
