"""Extended-precision dense linear algebra on top of the GEMM engine (§V-A).

The port of ``repro.core.linalg``.  ``rgetrf`` is the blocked
right-looking LU of MPLAPACK's Rgetrf as the paper modifies it: panel
factorization and triangular solve on the host path, and the O(n^3)
trailing update ``A22 -= L21 @ U12`` routed through ``rgemm`` (step 5 of
the paper's algorithm, the part it offloads to the accelerator).

Every routine is limb-count generic through ``core.mp``.  The reference's
masked ``fori_loop``s over static shapes become Python loops over slices:
each step computes the same elementwise tier ops on the rows and columns
the mask would have kept, and pivots are int64 tensors on the operands'
device.  Unlike the reference, the triangular solves sum each row over
the solved prefix only (not over a zero-masked full row), so the
halving-tree pairing — and with it the last bits — may differ from it.
"""

from __future__ import annotations

import torch

from . import mp
from .blas import rgemm

__all__ = ["rgetrf", "rgetrf2", "rtrsm", "rpotrf", "lu_solve",
           "cholesky_solve", "apply_pivots", "pivot_permutation"]


def _clone(x):
    return mp.map_limbs(lambda l: l.clone(), x)


def _set(dst, idx, src):
    """dst[idx] = src, limb-wise and in place."""
    for d, s in zip(mp.limbs(dst), mp.limbs(src)):
        d[idx] = s


def rgetrf2(a):
    """Unblocked LU with partial pivoting on an (m, nb) panel.

    Returns ``(panel_lu, piv)`` with piv[j] = row swapped with j at step j
    (int64, on the panel's device).  The input is not modified.
    """
    x = _clone(a)
    m, nb = x.shape
    piv = []
    for j in range(min(m, nb)):
        # first max of |hi| over rows j.. (torch.argmax keeps the first)
        p = j + int(torch.argmax(torch.abs(mp.limbs(x)[0][j:, j])))
        piv.append(p)
        if p != j:
            for l in mp.limbs(x):
                l[[j, p]] = l[[p, j]]
        pivot = x[j:j + 1, j:j + 1]
        col = x[j + 1:, j:j + 1]
        new_col = mp.div(col, mp.broadcast_to(pivot, col.shape))
        _set(x, (slice(j + 1, None), slice(j, j + 1)), new_col)
        # trailing rank-1 update: A[i, c] -= L[i, j] * U[j, c]  (i, c > j)
        upd = mp.mul(new_col, x[j:j + 1, j + 1:])
        _set(x, (slice(j + 1, None), slice(j + 1, None)),
             mp.sub(x[j + 1:, j + 1:], upd))
    dev = mp.limbs(x)[0].device
    return x, torch.tensor(piv, dtype=torch.int64, device=dev)


def _trsm_left(t, b, *, lower: bool, unit_diag: bool):
    """Solve T X = B for triangular T by substitution, row by row."""
    nb = t.shape[0]
    x = _clone(b)
    order = range(nb) if lower else range(nb - 1, -1, -1)
    for i in order:
        xi = b[i]
        solved = slice(0, i) if lower else slice(i + 1, nb)
        if (i if lower else nb - 1 - i) > 0:
            trow = mp.map_limbs(lambda l: l[i, solved][:, None], t)
            contrib = mp.sum_(mp.mul(trow, x[solved]), axis=0)
            xi = mp.sub(xi, contrib)
        if not unit_diag:
            piv = t[i:i + 1, i]
            xi = mp.div(xi, mp.broadcast_to(piv, xi.shape))
        _set(x, i, xi)
    return x


def rtrsm(t, b, *, side: str = "left", lower: bool = True,
          unit_diag: bool = False, transpose_a: bool = False):
    """Triangular solve: op(T) X = B (side='left') or X op(T) = B ('right').

    The right-side form rides the left-side solve through the transpose
    identity X op(T) = B  <=>  op(T)^T X^T = B^T.
    """
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    if side == "right":
        bt = mp.map_limbs(lambda l: l.transpose(-1, -2), b)
        xt = rtrsm(t, bt, lower=lower, unit_diag=unit_diag,
                   transpose_a=not transpose_a)
        return mp.map_limbs(lambda l: l.transpose(-1, -2).contiguous(), xt)
    if transpose_a:
        t = mp.map_limbs(lambda l: l.T, t)
        lower = not lower
    return _trsm_left(t, b, lower=lower, unit_diag=unit_diag)


def pivot_permutation(piv, m: int, offset: int = 0, *,
                      inverse: bool = False):
    """Gather index ``perm`` such that ``x[perm]`` applies LAPACK's
    sequential interchanges piv (``inverse=True`` plays them backwards).
    Built on the host from the pivot list, returned on piv's device."""
    steps = [int(p) for p in torch.as_tensor(piv).tolist()]
    perm = list(range(m))
    order = reversed(range(len(steps))) if inverse else range(len(steps))
    for j in order:
        jj, pj = j + offset, steps[j] + offset
        perm[jj], perm[pj] = perm[pj], perm[jj]
    dev = piv.device if isinstance(piv, torch.Tensor) else None
    return torch.tensor(perm, dtype=torch.int64, device=dev)


def apply_pivots(x, piv, offset: int = 0, *, inverse: bool = False):
    """Apply LAPACK-style sequential row interchanges piv (local indices)."""
    perm = pivot_permutation(piv, x.shape[0], offset, inverse=inverse)
    return mp.map_limbs(lambda l: l[perm.to(l.device)], x)


def rgetrf(a, block: int = 64, plan=None, **plan_overrides):
    """Blocked LU with partial pivoting (paper's Rgetrf, steps 1-6).

    Returns (lu, piv) with L\\U packed and piv the global LAPACK-style
    interchange vector (int64).  The trailing updates go through
    ``rgemm``, each shrinking (m-p, nb, n-p) shape planned per call.
    """
    m, n = a.shape
    if m != n:
        raise ValueError(f"rgetrf takes square matrices, got {a.shape}")
    lu = _clone(a)
    piv_parts = []
    for p0 in range(0, n, block):
        nb = min(block, n - p0)
        panel_lu, ppiv = rgetrf2(lu[p0:, p0:p0 + nb])
        piv_parts.append(ppiv + p0)
        # apply the panel's row swaps to the columns outside the panel
        _set(lu, (slice(p0, None), slice(None)),
             apply_pivots(lu[p0:, :], ppiv))
        _set(lu, (slice(p0, None), slice(p0, p0 + nb)), panel_lu)
        if p0 + nb < n:
            l11 = lu[p0:p0 + nb, p0:p0 + nb]
            u12 = rtrsm(l11, lu[p0:p0 + nb, p0 + nb:], lower=True,
                        unit_diag=True)
            _set(lu, (slice(p0, p0 + nb), slice(p0 + nb, None)), u12)
            # the accelerated step: A22 -= L21 @ U12
            upd = rgemm("n", "n", -1.0, lu[p0 + nb:, p0:p0 + nb], u12, 1.0,
                        lu[p0 + nb:, p0 + nb:], plan=plan, **plan_overrides)
            _set(lu, (slice(p0 + nb, None), slice(p0 + nb, None)), upd)
    return lu, torch.cat(piv_parts)


def lu_solve(lu, piv, b):
    """Solve A x = b given rgetrf output (forward + backward substitution)."""
    y = rtrsm(lu, apply_pivots(b, piv), lower=True, unit_diag=True)
    return rtrsm(lu, y, lower=False, unit_diag=False)


def rpotrf(a):
    """Lower Cholesky factor in multi-limb arithmetic: A = L L^T."""
    lmat = mp.map_limbs(torch.tril, _clone(a))
    n = a.shape[0]
    for j in range(n):
        ajj = lmat[j:j + 1, j]
        rowj = lmat[j:j + 1, :j]
        if j:
            ajj = mp.sub(ajj, mp.sum_(mp.mul(rowj, rowj), axis=1))
        d = mp.sqrt(ajj)
        _set(lmat, (slice(j, j + 1), j), d)
        if j + 1 < n:
            num = lmat[j + 1:, j]
            if j:
                num = mp.sub(num, mp.sum_(
                    mp.mul(lmat[j + 1:, :j], mp.broadcast_to(
                        rowj, (n - j - 1, j))), axis=1))
            _set(lmat, (slice(j + 1, None), j),
                 mp.div(num, mp.broadcast_to(d, num.shape)))
    return lmat


def cholesky_solve(l, b):
    """Solve (L L^T) x = b."""
    y = rtrsm(l, b, lower=True, unit_diag=False)
    return rtrsm(l, y, lower=True, unit_diag=False, transpose_a=True)
