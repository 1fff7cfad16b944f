"""Quad-word expansion arithmetic (4 limbs) — past-binary128 precision.

The port of ``repro.core.qd``: every function is a thin binding of the
count-parametric family in ``core/mp.py`` at k == 4.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve_device
from . import mp as _mp
from .dd import as_tensor
from .mp import renorm_list  # re-exported; kernels distill through it

__all__ = ["QD", "from_float", "from_dd", "to_float", "to_dd", "zeros",
           "add", "sub", "mul", "mul_float", "mul_pow2", "neg", "abs_",
           "fma", "div", "sqrt", "where", "sum_", "dot", "eps",
           "renorm_list"]


class QD(NamedTuple):
    x0: torch.Tensor
    x1: torch.Tensor
    x2: torch.Tensor
    x3: torch.Tensor

    @property
    def dtype(self):
        return self.x0.dtype

    @property
    def shape(self):
        return tuple(self.x0.shape)

    @property
    def device(self):
        return self.x0.device

    def limbs(self):
        return [self.x0, self.x1, self.x2, self.x3]

    def __getitem__(self, idx):
        return QD(self.x0[idx], self.x1[idx], self.x2[idx], self.x3[idx])

    def reshape(self, *shape):
        return QD(*[l.reshape(*shape) for l in self.limbs()])


def eps(dtype=torch.float64) -> float:
    """Unit roundoff of the QD format with the given limb dtype."""
    return _mp.eps_for(4, dtype)


def from_float(x, dtype=None, device=None) -> QD:
    x = as_tensor(x, dtype, device)
    return QD(x, *[torch.zeros_like(x) for _ in range(3)])


def from_dd(x) -> QD:
    return QD(x.hi, x.lo, torch.zeros_like(x.hi), torch.zeros_like(x.hi))


def to_float(t: QD):
    return ((t.x3 + t.x2) + t.x1) + t.x0


def to_dd(t: QD):
    from . import dd as _dd

    return _dd.DD(*_mp.to_dd_limbs(t.limbs()))


def zeros(shape, dtype=torch.float64, device=None) -> QD:
    return from_float(torch.zeros(shape, dtype=dtype,
                                  device=resolve_device(device)))


def neg(t: QD) -> QD:
    return QD(-t.x0, -t.x1, -t.x2, -t.x3)


def abs_(t: QD) -> QD:
    # the leading limb carries the sign of the whole expansion
    m = t.x0 < 0
    return QD(*[torch.where(m, -l, l) for l in t.limbs()])


def where(c, a: QD, b: QD) -> QD:
    return QD(*[torch.where(c, x, y) for x, y in zip(a.limbs(), b.limbs())])


def add(a: QD, b: QD) -> QD:
    return QD(*_mp.add_limbs(a.limbs(), b.limbs()))


def sub(a: QD, b: QD) -> QD:
    return add(a, neg(b))


def mul(a: QD, b: QD) -> QD:
    return QD(*_mp.mul_limbs(a.limbs(), b.limbs()))


def mul_float(a: QD, b) -> QD:
    return QD(*_mp.mul_float_limbs(a.limbs(), b))


def mul_pow2(a: QD, s) -> QD:
    """Exact scaling by a power of two."""
    return QD(*_mp.mul_pow2_limbs(a.limbs(), s))


def fma(acc: QD, a: QD, b: QD) -> QD:
    return add(acc, mul(a, b))


def div(a: QD, b: QD) -> QD:
    return QD(*_mp.div_limbs(a.limbs(), b.limbs()))


def sqrt(a: QD) -> QD:
    return QD(*_mp.sqrt_limbs(a.limbs()))


def sum_(a: QD, axis=None, keepdims=False) -> QD:
    return QD(*_mp.sum_limbs(a.limbs(), axis=axis, keepdims=keepdims))


def dot(a: QD, b: QD) -> QD:
    """Inner product of two QD vectors with QD accumulation."""
    return sum_(mul(a, b), axis=0)
