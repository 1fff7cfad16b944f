"""Triple-word expansion arithmetic (3 limbs) — the ~159-bit middle rung.

The port of ``repro.core.td``: every function is a thin binding of the
count-parametric family in ``core/mp.py`` at k == 3.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve_device
from . import mp as _mp
from .dd import as_tensor
from .mp import renorm_list  # re-exported, mirroring qd

__all__ = ["TD", "from_float", "from_dd", "to_float", "to_dd", "zeros",
           "add", "sub", "mul", "mul_float", "mul_pow2", "neg", "abs_",
           "fma", "div", "sqrt", "where", "sum_", "dot", "eps",
           "renorm_list"]


class TD(NamedTuple):
    x0: torch.Tensor
    x1: torch.Tensor
    x2: torch.Tensor

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
        return [self.x0, self.x1, self.x2]

    def __getitem__(self, idx):
        return TD(self.x0[idx], self.x1[idx], self.x2[idx])

    def reshape(self, *shape):
        return TD(*[l.reshape(*shape) for l in self.limbs()])


def eps(dtype=torch.float64) -> float:
    """Unit roundoff of the TD format with the given limb dtype."""
    return _mp.eps_for(3, dtype)


def from_float(x, dtype=None, device=None) -> TD:
    x = as_tensor(x, dtype, device)
    return TD(x, torch.zeros_like(x), torch.zeros_like(x))


def from_dd(x) -> TD:
    return TD(x.hi, x.lo, torch.zeros_like(x.hi))


def to_float(t: TD):
    return (t.x2 + t.x1) + t.x0


def to_dd(t: TD):
    from . import dd as _dd

    return _dd.DD(*_mp.to_dd_limbs(t.limbs()))


def zeros(shape, dtype=torch.float64, device=None) -> TD:
    return from_float(torch.zeros(shape, dtype=dtype,
                                  device=resolve_device(device)))


def neg(t: TD) -> TD:
    return TD(-t.x0, -t.x1, -t.x2)


def abs_(t: TD) -> TD:
    # the leading limb carries the sign of the whole expansion
    m = t.x0 < 0
    return TD(*[torch.where(m, -l, l) for l in t.limbs()])


def where(c, a: TD, b: TD) -> TD:
    return TD(*[torch.where(c, x, y) for x, y in zip(a.limbs(), b.limbs())])


def add(a: TD, b: TD) -> TD:
    return TD(*_mp.add_limbs(a.limbs(), b.limbs()))


def sub(a: TD, b: TD) -> TD:
    return add(a, neg(b))


def mul(a: TD, b: TD) -> TD:
    return TD(*_mp.mul_limbs(a.limbs(), b.limbs()))


def mul_float(a: TD, b) -> TD:
    return TD(*_mp.mul_float_limbs(a.limbs(), b))


def mul_pow2(a: TD, s) -> TD:
    """Exact scaling by a power of two."""
    return TD(*_mp.mul_pow2_limbs(a.limbs(), s))


def fma(acc: TD, a: TD, b: TD) -> TD:
    return add(acc, mul(a, b))


def div(a: TD, b: TD) -> TD:
    return TD(*_mp.div_limbs(a.limbs(), b.limbs()))


def sqrt(a: TD) -> TD:
    return TD(*_mp.sqrt_limbs(a.limbs()))


def sum_(a: TD, axis=None, keepdims=False) -> TD:
    return TD(*_mp.sum_limbs(a.limbs(), axis=axis, keepdims=keepdims))


def dot(a: TD, b: TD) -> TD:
    """Inner product of two TD vectors with TD accumulation."""
    return sum_(mul(a, b), axis=0)
