"""Error-free transformations (EFTs) on torch tensors.

The port of ``repro.core.efts``, op for op:

  two_sum(a, b)        -> (s, e)  with  s = fl(a+b),  s + e == a + b  exactly
  quick_two_sum(a, b)  -> same, requires |a| >= |b| (3 ops instead of 6)
  two_prod(a, b)       -> (p, e)  with  p + e == a * b * (1 + eps_tp)

The same contraction-robust design holds here: the operand split masks
mantissa bits through an int64 view (no float multiply to contract), and
``p`` is assembled from the four exact partial products with two_sum
chains.  Eager torch runs every op as its own kernel, so nothing is fused;
the CUDA kernels that repeat these sequences (``csrc/dd_device.cuh``) are
built with ``--fmad=false`` and the ``__d*_rn`` intrinsics for the same
reason.  Relative error of two_prod: <= ~2^-105 for f64 limbs, 2^-47 for
f32.

The scale rescue (``_rescue``/``_unscale``) keeps two_prod within that
bound out to the edges of the exponent range: operands beyond 2^+-484 are
moved by 2^-+512 into a safe band and the integer unscale exponents are
summed before any float factor exists (see ``repro.core.efts`` for the
band arithmetic).  In-band operands compute bit-identically to the
unscaled algorithm.
"""

from __future__ import annotations

import torch

__all__ = [
    "two_sum",
    "quick_two_sum",
    "mask_split",
    "two_prod",
    "two_prod_terms",
    "two_prod_exact",
    "TWO_PROD_RELERR",
]

# relative error bound of two_prod per limb dtype (see module docstring)
TWO_PROD_RELERR = {
    torch.float64: 2.0**-104,
    torch.float32: 2.0**-46,
}

# (int view dtype, mantissa bits, exponent bias) per limb dtype
_BITS = {
    torch.float64: (torch.int64, 52, 1023),
    torch.float32: (torch.int32, 23, 127),
}


def two_sum(a, b):
    """Knuth's branch-free exact addition: s + e == a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Dekker's fast exact addition. Exact when |a| >= |b| (or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _bits(dtype):
    try:
        return _BITS[dtype]
    except KeyError:
        raise ValueError(f"unsupported limb dtype {dtype}") from None


def _mask_split_keep(a, keep: int):
    """Split off all but the top ``keep`` explicit mantissa bits.

    The mask is a negative int (two's complement), e.g. ``-(1 << 27)`` is
    0xFFFFFFFFF8000000 for f64: torch has few uint64 ops, int64 suffices.
    """
    ity, mant, _ = _bits(a.dtype)
    hi = (a.view(ity) & -(1 << (mant - keep))).view(a.dtype)
    return hi, a - hi


def mask_split(a):
    """Split a == hi + lo exactly by masking low mantissa bits (integer ops).

    hi keeps the top ~p/2 mantissa bits (26 of f64's 52 explicit bits, 12
    of f32's 23); lo = a - hi is exact (Sterbenz).
    """
    return _mask_split_keep(a, 25 if a.dtype == torch.float64 else 11)


# (tiny, huge, up, shift) per limb dtype, as in repro.core.efts._RESCUE
_RESCUE = {
    torch.float64: (2.0 ** -484, 2.0 ** 484, 2.0 ** 512, 512),
    torch.float32: (2.0 ** -60, 2.0 ** 60, 2.0 ** 64, 64),
}


def _rescue(x):
    """(x * s, e) with s = 2^-e an exact pow2 moving x into the safe band.

    e is the int32 UNSCALE exponent; e == 0 (and s == 1) for in-band
    operands.  NaN/Inf/0 pass through as in the reference.
    """
    tiny, huge, up, shift = _RESCUE[x.dtype]
    ax = torch.abs(x)
    small, big = ax < tiny, ax > huge
    s = torch.where(small, torch.full_like(x, up),
                    torch.where(big, torch.full_like(x, 1.0 / up),
                                torch.ones_like(x)))
    zero = torch.zeros_like(x, dtype=torch.int32)
    e = torch.where(small, zero - shift, torch.where(big, zero + shift, zero))
    return x * s, e


def _pow2(e, dtype):
    """Exact 2.0**e via the exponent field (e in the normal range)."""
    ity, mant, bias = _bits(dtype)
    return ((e.to(ity) + bias) << mant).view(dtype)


def _unscale(x, ea, eb):
    """x * 2^(ea+eb), the integer sum formed before any float factor, and
    applied as two exact normal-range halves (shift sums are even)."""
    e = ea + eb
    h = torch.div(e, 2, rounding_mode="floor")
    return x * _pow2(h, x.dtype) * _pow2(e - h, x.dtype)


def two_prod(a, b):
    """Near-exact multiplication: p + e == a*b up to TWO_PROD_RELERR[dtype]."""
    a, ea = _rescue(a)
    b, eb = _rescue(b)
    ah, al = mask_split(a)
    bh, bl = mask_split(b)
    m1 = ah * bh  # exact
    m2 = ah * bl  # exact
    m3 = al * bh  # exact
    m4 = al * bl  # <= 1/2 ulp error at 2^-(2p+2)|ab| scale
    s, e1 = two_sum(m1, m2)
    s, e2 = two_sum(s, m3)
    s, e3 = two_sum(s, m4)
    e = e1 + (e2 + e3)
    return _unscale(s, ea, eb), _unscale(e, ea, eb)


def _scaled_terms(a, b):
    """Exact product terms of the rescued operands, plus unscale exponents."""
    a, ea = _rescue(a)
    b, eb = _rescue(b)
    ah, al = mask_split(a)
    bh, bl = mask_split(b)
    if a.dtype == torch.float64:
        blh, bll = _mask_split_keep(bl, 12)  # 27-bit al x {13, 14}-bit halves
        terms = [ah * bh, ah * bl, al * bh, al * blh, al * bll]
    else:
        terms = [ah * bh, ah * bl, al * bh, al * bl]  # f32: 12/12, all exact
    return terms, ea, eb


def two_prod_terms(a, b):
    """a*b as a list of floats summing to the product EXACTLY."""
    terms, ea, eb = _scaled_terms(a, b)
    return [_unscale(t, ea, eb) for t in terms]


def two_prod_exact(a, b):
    """Exact two_prod: p + e == a*b exactly (distilled from exact terms)."""
    terms, ea, eb = _scaled_terms(a, b)
    for _ in range(3):  # vecsum sweeps converge the fixed-size expansion
        out = [None] * len(terms)
        s = terms[-1]
        for i in range(len(terms) - 2, -1, -1):
            s, err = two_sum(terms[i], s)
            out[i + 1] = err
        out[0] = s
        terms = out
    e = terms[1]
    for t in terms[2:]:
        e, r = two_sum(e, t)
        e = e + r
    p, e = quick_two_sum(terms[0], e)
    return _unscale(p, ea, eb), _unscale(e, ea, eb)
