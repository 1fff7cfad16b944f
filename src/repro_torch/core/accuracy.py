"""Accuracy oracle: exact-rational Hilbert-matrix GEMM, and the shared
conformance metric.

The port of ``repro.core.accuracy`` (its Fraction helpers copied, so the
port imports nothing of the reference).  The Hilbert matrix H_ij =
1/(i+j+1) is formed IN tier arithmetic (a multi-limb division, so every
limb carries signal), H @ H is evaluated exactly over those representable
entries with ``fractions.Fraction``, and each tier's engine output must
stay within its gate:

    dd <= 2^-100,   td <= 2^-150,   qd <= 2^-190
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np
import torch

from .._device import resolve_device
from . import mp

__all__ = ["GATES", "hilbert_f64", "hilbert_tier", "hilbert_relative_error",
           "max_rel_err", "frac_matrix", "frac_matmul", "frac_sub",
           "frac_max_abs"]

# per-tier observed-relative-error ceilings (the regression gate)
GATES = {"dd": 2.0 ** -100, "td": 2.0 ** -150, "qd": 2.0 ** -190}


def hilbert_f64(n: int) -> np.ndarray:
    """Hilbert matrix H_ij = 1/(i+j+1), rounded once to f64."""
    i = np.arange(n, dtype=np.float64)
    return 1.0 / (i[:, None] + i[None, :] + 1.0)


def _limbs_np(x):
    return [l.detach().cpu().numpy().astype(np.float64) for l in mp.limbs(x)]


def max_rel_err(got, want) -> float:
    """Max |got - want| / max(1, max|want|), measured in the values' tier."""
    diff = torch.abs(mp.to_float(mp.sub(got, want)))
    scale = max(1.0, float(torch.max(torch.abs(mp.to_float(want)))))
    return float(torch.max(diff)) / scale


def hilbert_tier(precision: str, n: int, device=None):
    """Hilbert matrix formed in tier arithmetic (``device=None`` -> CUDA)."""
    dev = resolve_device(device)
    i = torch.arange(n, dtype=torch.float64, device=dev)
    denom = i[:, None] + i[None, :] + 1.0
    one = mp.from_float(torch.ones((n, n), dtype=torch.float64, device=dev),
                        precision)
    return mp.div(one, mp.from_float(denom, precision))


def _frac(limbs_np, i: int, j: int) -> Fraction:
    return sum((Fraction(float(l[i, j])) for l in limbs_np), Fraction(0))


def frac_matrix(x):
    """Exact rational entries of a 2-D multi-limb value."""
    ls = _limbs_np(x)
    m, n = ls[0].shape
    return [[_frac(ls, i, j) for j in range(n)] for i in range(m)]


def frac_matmul(fa, fb):
    """Exact rational product of two Fraction matrices."""
    inner = len(fb)
    cols = len(fb[0])
    return [[sum((fa[i][k] * fb[k][j] for k in range(inner)), Fraction(0))
             for j in range(cols)] for i in range(len(fa))]


def frac_sub(fa, fb):
    return [[x - y for x, y in zip(ra, rb)] for ra, rb in zip(fa, fb)]


def frac_max_abs(f) -> float:
    """max |entry| of a Fraction matrix, rounded once to f64 at the end."""
    return float(max(abs(e) for row in f for e in row))


@functools.lru_cache(maxsize=8)
def _square_oracle(limb_bytes: tuple, n: int):
    """Exact rational X @ X over the representable entries of X (given as
    the bytes of its f64 limbs): shared by every backend under test."""
    ls = [np.frombuffer(b, dtype=np.float64).reshape(n, n)
          for b in limb_bytes]
    fx = [[_frac(ls, i, j) for j in range(n)] for i in range(n)]
    return frac_matmul(fx, fx)


def hilbert_relative_error(precision: str = "dd", n: int = 16,
                           backend: str = "xla", device=None,
                           **overrides) -> float:
    """Max relative error of one engine backend on H @ H against the exact
    rational product of the tier's own H entries (``overrides`` feed the
    planner, e.g. ``slice_dtype=``/``acc_dtype=``)."""
    from ..gemm import matmul

    x = hilbert_tier(precision, n, device)
    got = _limbs_np(matmul(x, x, backend=backend, **overrides))
    want = _square_oracle(tuple(l.tobytes() for l in _limbs_np(x)), n)
    worst = 0.0
    for i in range(n):
        for j in range(n):
            rel = abs(float((_frac(got, i, j) - want[i][j]) / want[i][j]))
            worst = max(worst, rel)
    return worst
