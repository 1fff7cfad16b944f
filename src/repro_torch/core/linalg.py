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
device.  The sums of the triangular solves and of the Cholesky factor run
over the full masked row, as the reference's do: ``mp.sum_``'s halving
tree pairs its terms by position, so a prefix-only sum would round
differently.
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
    """Solve T X = B for triangular T by substitution, row by row.

    Each row's update sums over all nb rows, T's row masked to the solved
    ones and X zero where unsolved, as the reference's ``_trsm`` does: the
    halving tree of ``mp.sum_`` pairs its terms by position, so summing
    only the solved prefix would round differently.  The masked rows are
    T's strict triangle, cut once.
    """
    nb = t.shape[0]
    x = mp.map_limbs(torch.zeros_like, b)
    strict = mp.map_limbs(
        (lambda l: torch.tril(l, -1)) if lower else
        (lambda l: torch.triu(l, 1)), t)
    order = range(nb) if lower else range(nb - 1, -1, -1)
    for i in order:
        tcol = mp.map_limbs(lambda l: l[i][:, None], strict)
        xi = mp.sub(b[i], mp.sum_(mp.mul(tcol, x), axis=0))
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
    """Lower Cholesky factor in multi-limb arithmetic: A = L L^T.

    The sums of step j run over all n columns of L, whose columns k >= j
    are still zero, as the reference's ``_potrf`` masks them (``mp.sum_``'s
    halving tree pairs its terms by position, so a j-term sum would round
    differently).  L starts at zero and gains column j at step j, so it is
    its own mask.
    """
    lmat = mp.map_limbs(torch.zeros_like, a)
    n = a.shape[0]
    for j in range(n):
        rowj = lmat[j:j + 1]
        d = mp.sqrt(mp.sub(a[j:j + 1, j],
                           mp.sum_(mp.mul(rowj, rowj), axis=1)))
        if j + 1 < n:  # before column j is written: it is still zero
            num = mp.sub(a[j + 1:, j], mp.sum_(mp.mul(
                lmat[j + 1:], mp.broadcast_to(rowj, (n - j - 1, n))), axis=1))
            _set(lmat, (slice(j + 1, None), j),
                 mp.div(num, mp.broadcast_to(d, num.shape)))
        _set(lmat, (slice(j, j + 1), j), d)
    return lmat


def cholesky_solve(l, b):
    """Solve (L L^T) x = b."""
    y = rtrsm(l, b, lower=True, unit_diag=False)
    return rtrsm(l, y, lower=True, unit_diag=False, transpose_a=True)
