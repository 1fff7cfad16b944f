"""Ozaki-scheme GEMM: binary128-class matmul out of native f64 GEMMs.

The port of ``repro.core.ozaki``.  Each operand is cut into error-free
slices per row of A / column of B (Rump's ExtractVector on a fixed
power-of-two anchor ladder), every slice-pair product is exact in the f64
accumulator, and the products are recombined diagonal by diagonal: the
pair dots with equal significance d = s + t are summed natively first,
then folded into the multi-limb result once per diagonal.

Exactness condition (grouped form): ``2*beta + ceil(log2 k) +
ceil(log2 n_slices) <= p_acc``.  Every partial sum of a diagonal is then
representable, so the slice dots give the same bits in any summation
order — here they are plain ``torch.matmul`` calls in f64, as they are
plain XLA dots in the reference.  ``slice_params`` solves (beta,
n_slices) once; the plan carries them so kernels never re-derive them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import dd, mp

__all__ = ["ozaki_gemm", "slice_count", "slice_bits", "slice_params",
           "platform_dtypes"]

_P_ACC = {torch.float64: 53, torch.float32: 24}

_DTYPES = {"float64": torch.float64, "float32": torch.float32,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


def as_dtype(x) -> torch.dtype:
    """A torch dtype from a dtype or its name ('float64', ...)."""
    return x if isinstance(x, torch.dtype) else _DTYPES[str(x)]


def platform_dtypes(platform: str):
    """(slice_dtype, acc_dtype) for a platform.

    ``cuda`` and ``cpu`` both slice and accumulate in f64: the H100 has
    native f64 (and f64 tensor cores for a later kernel), so the exactness
    algebra is the reference's CPU one.
    """
    if platform in ("cuda", "cpu"):
        return torch.float64, torch.float64
    raise ValueError(f"unknown platform {platform!r}; one of "
                     f"('cuda', 'cpu')")


def slice_bits(k: int, acc_dtype, slice_dtype=None, group: int = 1) -> int:
    """Max bits per slice for exact accumulation over a k-deep GEMM."""
    acc_dtype = as_dtype(acc_dtype)
    p_acc = _P_ACC[acc_dtype]
    head = math.ceil(math.log2(max(k, 2)))
    if group > 1:
        head += math.ceil(math.log2(group))
    beta = (p_acc - head) // 2
    if slice_dtype is not None and as_dtype(slice_dtype) == torch.bfloat16:
        beta = min(beta, 8)  # bf16 mantissa (incl. implicit bit)
    if beta < 1:
        raise ValueError(f"k={k} too deep for exact slicing in {acc_dtype}")
    return beta


def slice_count(target_bits: int, beta: int) -> int:
    """Slices per operand to cover target_bits of significand."""
    return math.ceil(target_bits / beta) + 1


def slice_params(k: int, acc_dtype, slice_dtype=None, *,
                 target_bits: int = 107, n_slices: int | None = None,
                 beta: int | None = None,
                 guard_bits: int = 4) -> tuple[int, int]:
    """Solve (beta, n_slices) for the diagonal-grouped scheme (the short
    fixpoint of ``repro.core.ozaki.slice_params``); either may be pinned.
    Raises ValueError when k is too deep for exact slicing."""
    need = target_bits + math.ceil(math.log2(max(k, 2))) + guard_bits
    if beta is not None:
        s = n_slices if n_slices is not None \
            else max(2, math.ceil(need / beta))
        limit = slice_bits(k, acc_dtype, slice_dtype, group=s)
        if beta > limit:
            raise ValueError(
                f"beta={beta} violates exact accumulation for k={k}, "
                f"n_slices={s} in {as_dtype(acc_dtype)} "
                f"(max {limit}: 2*beta + log2(k*n_slices) must fit p_acc)")
        return beta, s
    if n_slices is not None:
        return slice_bits(k, acc_dtype, slice_dtype, group=n_slices), n_slices
    s = max(2, math.ceil(need / slice_bits(k, acc_dtype, slice_dtype)))
    for _ in range(16):
        beta = slice_bits(k, acc_dtype, slice_dtype, group=s)
        s_next = max(2, math.ceil(need / beta))
        if s_next == s:
            break
        s = s_next
    return beta, s


def _pow2_near(mu):
    """Exact power of two ~mu: mu / mantissa(mu) == 2^exponent(mu)."""
    floor = 2.0 ** -511 if mu.dtype == torch.float64 else 2.0 ** -63
    mu = torch.clamp_min(mu, floor)
    m, _ = torch.frexp(mu)  # mu = m * 2^e, m in [0.5, 1)
    return mu / m


def _extract_slices(x, beta: int, n_slices: int, axis: int, ops=mp):
    """Error-free slices along rows (axis=-1, for A) or columns (axis=-2).

    Anchor sigma_0 = 2^(exponent(mu) + p - beta) from the row/column max mu
    of the leading limb, then sigma_i = sigma_0 * 2^(-i*beta): slice i of
    every row sits on one fixed grid, which the diagonal-grouped exactness
    proof needs.  ``(hi + sigma) - sigma`` is never reassociated (eager
    torch runs each op as written).  The residual subtraction runs in the
    value's own tier, so lower limbs surface in later slices: through
    ``ops``, ``mp`` (a kernel launch on the card) or the value's tier module
    (``mp.tier_module``, the plain version).
    """
    lead = mp.limbs(x)[0]
    pbits = 53 if lead.dtype == torch.float64 else 24
    prec = mp.precision_of(x)
    mu = torch.amax(torch.abs(lead), dim=axis, keepdim=True)
    sigma = _pow2_near(mu) * (2.0 ** (pbits - beta))
    nonzero = mu > 0
    slices = []
    r = x
    for _ in range(n_slices):
        hi = mp.limbs(r)[0]
        s = torch.where(nonzero, (hi + sigma) - sigma, torch.zeros_like(hi))
        slices.append(s)
        r = ops.sub(r, mp.from_float(s, prec))
        sigma = sigma * (2.0 ** -beta)
    return slices


def _diagonal_pairs(d: int, n_slices: int):
    """(s, t) slice pairs on diagonal d = s + t, most-significant A first."""
    return [(i, d - i) for i in range(max(0, d - n_slices + 1),
                                      min(d + 1, n_slices))]


def _normalize_slices(slices, beta: int, axis: int, slice_dtype):
    """Ladder-normalize slices into a narrow dtype, EXACTLY (each slice by
    2^(i*beta) / sc, all powers of two).  Returns (scaled slices, sc)."""
    sc = _pow2_near(torch.amax(torch.abs(slices[0]), dim=axis, keepdim=True))
    return [((s * (2.0 ** (i * beta))) / sc).to(as_dtype(slice_dtype))
            for i, s in enumerate(slices)], sc


def _fold_diagonal_sum(acc, dsum):
    """acc += one diagonal's native-dtype sum, in acc's own tier: dd keeps
    the cheap ``add_float`` fold, wider counts distill k+1 terms."""
    if isinstance(acc, dd.DD):
        return dd.add_float(acc, dsum)
    k = len(acc.limbs())
    return mp.from_limbs(
        mp.renorm_list(list(acc.limbs()) + [dsum], k=k, sweeps=3))


def diagonal_sums(sa, sb, n_slices: int, full: bool, acc_dtype):
    """Yield (d, dsum): each diagonal's exact native sum of pair dots,
    most-significant diagonal first."""
    n_diag = (2 * n_slices - 1) if full else n_slices
    for d in range(n_diag):
        dsum = None
        for s, t in _diagonal_pairs(d, n_slices):
            p = torch.matmul(sa[s].to(acc_dtype), sb[t].to(acc_dtype))
            dsum = p if dsum is None else dsum + p
        yield d, dsum


def ozaki_gemm(a, b, *, slice_dtype=None, acc_dtype=None,
               n_slices: int | None = None, beta: int | None = None,
               target_bits: int = 107, full: bool = False):
    """C = A @ B via error-free slicing onto native GEMMs (whole K; leading
    batch dims broadcast through ``torch.matmul``)."""
    acc_dtype = as_dtype(acc_dtype or torch.float64)
    slice_dtype = as_dtype(slice_dtype or torch.float64)
    lead = mp.limbs(a)[0]
    k = lead.shape[-1]
    beta, n_slices = slice_params(k, acc_dtype, slice_dtype,
                                  target_bits=target_bits,
                                  n_slices=n_slices, beta=beta)
    limb_dtype = lead.dtype
    sa = _extract_slices(a, beta, n_slices, axis=-1)
    sb = _extract_slices(b, beta, n_slices, axis=-2)
    narrow = slice_dtype != limb_dtype
    if narrow:
        sa, sc_a = _normalize_slices(sa, beta, -1, slice_dtype)
        sb, sc_b = _normalize_slices(sb, beta, -2, slice_dtype)
    m, n = lead.shape[-2], mp.limbs(b)[0].shape[-1]
    batch = tuple(np.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
    acc = mp.zeros(batch + (m, n), mp.precision_of(a), dtype=limb_dtype,
                   device=lead.device)
    for d, dsum in diagonal_sums(sa, sb, n_slices, full, acc_dtype):
        if narrow:
            dsum = dsum.to(limb_dtype) * (sc_a * sc_b * (2.0 ** (-d * beta)))
        acc = _fold_diagonal_sum(acc, dsum.to(limb_dtype))
    return acc
