"""Double-word ("double-double") arithmetic — the binary128-class MAC.

The port of ``repro.core.dd``: a ``DD`` value is an unevaluated sum
``hi + lo`` of two f64 tensors with ``|lo| <= ulp(hi)/2`` (~106 mantissa
bits).  Every op runs the same error-free-transformation sequence as the
reference, so on the CPU the results match eager JAX calls bit for bit.
The Li add and the Dekker-style multiply below are exactly what the CUDA
systolic kernel (``csrc/mlgemm.cu``) repeats per output element.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from .efts import quick_two_sum, two_prod, two_sum

__all__ = [
    "DD", "dd", "from_float", "from_hi_lo", "to_float", "zeros", "add",
    "add_float", "sub", "neg", "abs_", "mul", "mul_float", "mul_pow2",
    "fma", "div", "sqrt", "sum_", "dot", "lt", "le", "gt", "ge", "where",
    "eps",
]


class DD(NamedTuple):
    """Unevaluated sum hi + lo. Leaves are torch tensors (any shape)."""

    hi: torch.Tensor
    lo: torch.Tensor

    @property
    def dtype(self):
        return self.hi.dtype

    @property
    def shape(self):
        return tuple(self.hi.shape)

    @property
    def device(self):
        return self.hi.device

    def __getitem__(self, idx):
        return DD(self.hi[idx], self.lo[idx])

    def reshape(self, *shape):
        return DD(self.hi.reshape(*shape), self.lo.reshape(*shape))

    def limbs(self):
        """Limb list, most-significant first (multi-limb-generic protocol)."""
        return [self.hi, self.lo]


def eps(dtype=torch.float64) -> float:
    """Unit roundoff of the DD format with the given limb dtype."""
    p = 53 if dtype == torch.float64 else 24
    return 2.0 ** (-2 * p)


def as_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """A tensor from a tensor (kept on its device unless ``device`` is
    given), or from numpy / a python number (``device=None`` -> CUDA)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype or x.dtype,
                    device=x.device if device is None else device)
    arr = np.asarray(x)
    if dtype is None:
        dtype = torch.float32 if arr.dtype == np.float32 else torch.float64
    return torch.as_tensor(arr, dtype=dtype, device=resolve_device(device))


def from_float(x, dtype=None, device=None) -> DD:
    x = as_tensor(x, dtype, device)
    return DD(x, torch.zeros_like(x))


def from_hi_lo(hi, lo) -> DD:
    """Renormalize an arbitrary (hi, lo) pair into canonical DD form."""
    return DD(*two_sum(hi, lo))


def dd(x, dtype=torch.float64, device=None) -> DD:
    """Coerce scalars/arrays/DD to DD."""
    if isinstance(x, DD):
        return x
    return from_float(x, dtype=dtype, device=device)


def to_float(x: DD):
    return x.hi + x.lo


def zeros(shape, dtype=torch.float64, device=None) -> DD:
    z = torch.zeros(shape, dtype=dtype, device=resolve_device(device))
    return DD(z, z.clone())


def neg(a: DD) -> DD:
    return DD(-a.hi, -a.lo)


def abs_(a: DD) -> DD:
    m = a.hi < 0
    return DD(torch.where(m, -a.hi, a.hi), torch.where(m, -a.lo, a.lo))


def add(a: DD, b: DD) -> DD:
    """Accurate DD + DD (Li et al. "IEEE add"; error <= 3 ulp^2)."""
    s, e = two_sum(a.hi, b.hi)
    t, f = two_sum(a.lo, b.lo)
    e = e + t
    s, e = quick_two_sum(s, e)
    e = e + f
    return DD(*quick_two_sum(s, e))


def sub(a: DD, b: DD) -> DD:
    return add(a, neg(b))


def add_float(a: DD, b) -> DD:
    s, e = two_sum(a.hi, b)
    e = e + a.lo
    return DD(*quick_two_sum(s, e))


def mul(a: DD, b: DD) -> DD:
    """DD * DD (error <= 4 ulp^2)."""
    p, e = two_prod(a.hi, b.hi)
    e = e + (a.hi * b.lo + a.lo * b.hi)
    return DD(*quick_two_sum(p, e))


def mul_float(a: DD, b) -> DD:
    p, e = two_prod(a.hi, b)
    e = e + a.lo * b
    return DD(*quick_two_sum(p, e))


def mul_pow2(a: DD, s) -> DD:
    """Exact scaling by a power of two."""
    return DD(a.hi * s, a.lo * s)


def fma(acc: DD, a: DD, b: DD) -> DD:
    """acc + a*b — the binary128-class multiply-add "PE" operation."""
    return add(acc, mul(a, b))


def div(a: DD, b: DD) -> DD:
    """Long-division style DD / DD (QD library algorithm)."""
    q1 = a.hi / b.hi
    r = sub(a, mul_float(b, q1))
    q2 = r.hi / b.hi
    r = sub(r, mul_float(b, q2))
    q3 = r.hi / b.hi
    q, e = quick_two_sum(q1, q2)
    return add_float(DD(q, e), q3)


def _ieee_sqrt(x):
    """Correctly rounded f64 sqrt.  torch's vectorized CPU kernel is not
    (it misses the last bit on ~1% of inputs); numpy's is, as are XLA's and
    CUDA's, so CPU tensors take numpy's."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.detach().numpy()))
    return torch.sqrt(x)


def sqrt(a: DD) -> DD:
    """DD sqrt via Karp's trick: x ~ 1/sqrt(hi); s = a*x; s + x*(a - s^2)/2."""
    x = 1.0 / _ieee_sqrt(a.hi)
    ax = a.hi * x
    ax_dd = from_float(ax)
    err = sub(a, mul(ax_dd, ax_dd))
    res = add_float(err, torch.zeros_like(err.hi))
    corr = res.hi * (x * 0.5)
    out = add_float(ax_dd, corr)
    # guard zero (sqrt(0) -> 0, avoid inf * 0 = nan)
    zero = a.hi == 0
    z = torch.zeros_like(out.hi)
    return DD(torch.where(zero, z, out.hi), torch.where(zero, z, out.lo))


def sum_(a: DD, axis=None, keepdims=False) -> DD:
    """Compensated reduction by repeated halving (every partial stays DD);
    an odd tail element is added onto the first partial, as in the
    reference."""
    if axis is None:
        return sum_(a.reshape(-1), axis=0, keepdims=keepdims)
    cur = DD(torch.movedim(a.hi, axis, 0), torch.movedim(a.lo, axis, 0))
    m = cur.hi.shape[0]
    while m > 1:
        half = m // 2
        even = DD(cur.hi[: 2 * half : 2], cur.lo[: 2 * half : 2])
        odd = DD(cur.hi[1 : 2 * half : 2], cur.lo[1 : 2 * half : 2])
        red = add(even, odd)
        if m % 2:
            red = add(red, DD(
                torch.cat([cur.hi[-1:], torch.zeros_like(red.hi[1:])], 0),
                torch.cat([cur.lo[-1:], torch.zeros_like(red.lo[1:])], 0)))
        cur = red
        m = half
    out = DD(cur.hi[0], cur.lo[0])
    if keepdims:
        out = DD(out.hi.unsqueeze(axis), out.lo.unsqueeze(axis))
    return out


def dot(a: DD, b: DD) -> DD:
    """Inner product of two DD vectors with DD accumulation."""
    return sum_(mul(a, b), axis=0)


def lt(a: DD, b: DD):
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo))


def le(a: DD, b: DD):
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo <= b.lo))


def gt(a: DD, b: DD):
    return lt(b, a)


def ge(a: DD, b: DD):
    return le(b, a)


def where(c, a: DD, b: DD) -> DD:
    return DD(torch.where(c, a.hi, b.hi), torch.where(c, a.lo, b.lo))
