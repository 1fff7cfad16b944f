"""Count-generic multi-limb arithmetic — one API over any limb count.

The port of ``repro.core.mp``.  ``dd`` (2 limbs, ~106 bits), ``td``
(3 limbs, ~159 bits) and ``qd`` (4 limbs, ~212 bits) share this seam:

  * **downward**, the count-parametric limb-list family (``renorm_list``
    and the ``*_limbs`` recipes: Priest/Hida-style expansions with
    CAMPARY branch-free renormalization) that ``td``/``qd`` bind at a
    fixed count; ``dd`` keeps its specialized two-limb algorithms;
  * **upward**, the tier-value API (``add``/``mul``/...) dispatched on the
    value type, so callers are written once against ``mp.*``.

The tier modules are imported lazily (they import the generic recipes from
here), and mixing tiers in one op raises ``TypeError``: re-tiering is an
explicit ``promote``.

On CUDA tensors the elementwise ops (``add``, ``sub``, ``mul``, ``fma``,
``div``, ``sqrt``, ``mul_float``) and ``sum_`` launch one fused kernel
each (``kernels/mpops.py``, ``csrc/mpops.cu``), bit for bit the tier
modules' arithmetic; on CPU tensors they run the tier modules' PyTorch
code.  ``tier_module(x)`` hands out that code directly, for the kernels'
plain versions, which never launch a kernel on any device.
"""

from __future__ import annotations

import importlib
from typing import Sequence

import torch

from .efts import quick_two_sum, two_prod_terms, two_sum

__all__ = [
    "PRECISIONS", "nlimbs", "precision_of", "precision_for_count", "limbs",
    "from_limbs", "map_limbs", "from_float", "zeros", "to_float", "promote",
    "add", "sub", "neg", "abs_", "mul", "mul_float", "fma", "div", "sqrt",
    "where", "sum_", "dot", "broadcast_to", "eps", "max_abs", "is_zero",
    "renorm_list", "add_limbs", "neg_limbs", "mul_limbs", "mul_float_limbs",
    "mul_pow2_limbs", "fma_limbs", "div_limbs", "sqrt_limbs", "sum_limbs",
    "to_dd_limbs", "eps_for", "tier_module",
]

# precision name -> limb count, in ladder order (cheapest rung first).
# Each name resolves to a tier module of the same name in this package
# whose value type is the upper-cased name (dd.DD, td.TD, qd.QD).
PRECISIONS = {"dd": 2, "td": 3, "qd": 4}

_BY_COUNT = {n: name for name, n in PRECISIONS.items()}


_MODS: dict = {}


def _tier_mod(precision: str):
    mod = _MODS.get(precision)
    if mod is None:
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}; "
                             f"one of {sorted(PRECISIONS)}")
        # lazy: tier modules import the generic kernels from here, so this
        # module must never import them at top level
        mod = _MODS[precision] = importlib.import_module(
            f".{precision}", __package__)
    return mod


def _tier_type(precision: str):
    return getattr(_tier_mod(precision), precision.upper())


def precision_for_count(n: int) -> str:
    """Precision name for a limb count (the inverse of ``PRECISIONS``)."""
    name = _BY_COUNT.get(n)
    if name is None:
        raise ValueError(f"unsupported limb count {n} "
                         f"(supported: {sorted(_BY_COUNT)})")
    return name


def precision_of(x) -> str:
    if isinstance(x, tuple) and hasattr(x, "limbs"):
        name = _BY_COUNT.get(len(x))
        if name is not None and isinstance(x, _tier_type(name)):
            return name
    raise TypeError(f"not a multi-limb value: {type(x).__name__}")


def _mod(x):
    return _tier_mod(precision_of(x))


def tier_module(x):
    """The tier module of ``x`` (``dd``, ``td`` or ``qd``): its arithmetic
    as PyTorch ops on any device, never a kernel launch."""
    return _mod(x)


def _kernel(x) -> bool:
    """True when ``x`` lives on the card (its ops launch the kernels)."""
    return x.limbs()[0].is_cuda


def _mpops(op, *args):
    from ..kernels.mpops import mpops_call

    return mpops_call(op, *args)


def _mod2(a, *others):
    """Dispatch module for a binary/ternary op, rejecting mixed tiers."""
    pa = precision_of(a)
    for o in others:
        if isinstance(o, tuple) and hasattr(o, "limbs"):
            po = precision_of(o)
            if po != pa:
                raise TypeError(
                    f"mixed precision tiers: {pa!r} and {po!r} "
                    f"(mp.promote one operand explicitly)")
    return _tier_mod(pa)


def nlimbs(x) -> int:
    return PRECISIONS[precision_of(x)]


def limbs(x) -> list:
    """Limb tensors, most-significant first."""
    precision_of(x)  # type check
    return x.limbs()


def from_limbs(ls):
    """Rebuild a tier value from its limb list (count picks the tier)."""
    ls = list(ls)
    return _tier_type(precision_for_count(len(ls)))(*ls)


def map_limbs(f, x):
    """Apply a structural (shape-only) function to every limb."""
    return from_limbs([f(l) for l in limbs(x)])


def from_float(x, precision: str = "dd", dtype=None, device=None):
    return _tier_mod(precision).from_float(x, dtype=dtype, device=device)


def zeros(shape, precision: str = "dd", dtype=torch.float64, device=None):
    return _tier_mod(precision).zeros(shape, dtype=dtype, device=device)


def to_float(x):
    return _mod(x).to_float(x)


def promote(x, precision: str):
    """Re-tier a value: climbing pads zero limbs (exact); descending
    distills the limb list to the narrower count (one rounding)."""
    kt = PRECISIONS.get(precision)
    if kt is None:
        raise ValueError(f"unknown precision {precision!r}; "
                         f"one of {sorted(PRECISIONS)}")
    cur = precision_of(x)
    if cur == precision:
        return x
    ls = limbs(x)
    if kt > len(ls):
        z = torch.zeros_like(ls[0])
        return from_limbs(ls + [z] * (kt - len(ls)))
    return from_limbs(renorm_list(ls, k=kt))


def add(a, b):
    mod = _mod2(a, b)
    if _kernel(a):
        return _mpops("add", a, b)
    return mod.add(a, b)


def sub(a, b):
    mod = _mod2(a, b)
    if _kernel(a):
        return _mpops("sub", a, b)
    return mod.sub(a, b)


def neg(a):
    return _mod(a).neg(a)


def abs_(a):
    return _mod(a).abs_(a)


def max_abs(a):
    """max |a| as an f64 0-dim tensor (the Rlange 'M' norm): the leading
    limb alone decides the magnitude ordering of a normalized expansion."""
    return torch.max(torch.abs(limbs(a)[0]))


def is_zero(x):
    """Bool tensor (elementwise): every limb of ``x`` is exactly zero."""
    z = None
    for l in limbs(x):
        e = l == 0
        z = e if z is None else torch.logical_and(z, e)
    return z


def mul(a, b):
    mod = _mod2(a, b)
    if _kernel(a):
        return _mpops("mul", a, b)
    return mod.mul(a, b)


def fma(acc, a, b):
    """acc + a*b — the multiply-add "PE" operation at acc's tier."""
    mod = _mod2(acc, a, b)
    if _kernel(acc):
        return _mpops("fma", acc, a, b)
    return mod.fma(acc, a, b)


def mul_float(a, s):
    mod = _mod(a)
    if _kernel(a):
        return _mpops("mul_float", a, s)
    return mod.mul_float(a, s)


def div(a, b):
    mod = _mod2(a, b)
    if _kernel(a):
        return _mpops("div", a, b)
    return mod.div(a, b)


def sqrt(a):
    mod = _mod(a)
    if _kernel(a):
        return _mpops("sqrt", a)
    return mod.sqrt(a)


def where(c, a, b):
    return _mod(a).where(c, a, b)


def sum_(a, axis=None, keepdims=False):
    mod = _mod(a)
    if _kernel(a):
        from ..kernels.mpops import sum_ as _sum

        return _sum(a, axis=axis, keepdims=keepdims)
    return mod.sum_(a, axis=axis, keepdims=keepdims)


def dot(a, b):
    mod = _mod2(a, b)
    if _kernel(a):
        return sum_(mul(a, b), axis=0)
    return mod.dot(a, b)


def broadcast_to(x, shape):
    return map_limbs(lambda l: torch.broadcast_to(l, shape), x)


def eps_for(k: int, dtype=torch.float64) -> float:
    """Unit roundoff of a k-limb expansion: 2^(-k*p) for p-bit limbs."""
    p = 53 if dtype == torch.float64 else 24
    return 2.0 ** (-k * p)


def eps(precision: str, dtype=torch.float64) -> float:
    """Unit roundoff of a tier: 2^-2p (dd), 2^-3p (td), 2^-4p (qd)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return eps_for(PRECISIONS[precision], dtype)


# --------------------------------------------------------------------------
# Count-generic limb-list kernel family (plain lists of limb tensors, most-
# significant first; the count is the list length).  The same EFT sequences
# as repro.core.mp, so results are bit-identical to eager JAX.
# --------------------------------------------------------------------------


def _vecsum_bottom_up(limbs: Sequence) -> list:
    """Bottom-up two_sum sweep: pushes the dominant mass into limb 0."""
    out = [None] * len(limbs)
    s = limbs[-1]
    for i in range(len(limbs) - 2, -1, -1):
        s, e = two_sum(limbs[i], s)
        out[i + 1] = e
    out[0] = s
    return out


def _compress_top_down(limbs: Sequence) -> list:
    """Top-down two_sum sweep: each error drops to the next slot. Exact."""
    acc = limbs[0]
    out = []
    for i in range(1, len(limbs)):
        acc, err = two_sum(acc, limbs[i])
        out.append(err)
    return [acc] + out


def renorm_list(terms: Sequence, k: int = 4, sweeps: int = 3) -> list:
    """Distill an arbitrary list of floats into a k-limb expansion."""
    limbs = list(terms)
    for _ in range(sweeps):
        limbs = _vecsum_bottom_up(limbs)
        limbs = _compress_top_down(limbs)
    head, tail = limbs[: k - 1], limbs[k - 1 :]
    last = tail[-1]
    for t in reversed(tail[:-1]):
        last = last + t
    head.append(last)
    # final canonicalizing pass
    return _compress_top_down(_vecsum_bottom_up(head))


def add_limbs(al: Sequence, bl: Sequence) -> list:
    """k-limb + k-limb: distill the concatenated expansions."""
    al, bl = list(al), list(bl)
    return renorm_list(al + bl, k=len(al), sweeps=3)


def neg_limbs(al: Sequence) -> list:
    return [-l for l in al]


def mul_limbs(al: Sequence, bl: Sequence) -> list:
    """Sloppy k-limb multiply: exact partial products through O(eps^(k-1))."""
    al, bl = list(al), list(bl)
    k = len(al)
    terms = []
    for i in range(k):
        for j in range(k):
            o = i + j
            if o < k - 1:
                terms.extend(two_prod_terms(al[i], bl[j]))
            elif o == k - 1:
                terms.append(al[i] * bl[j])
    return renorm_list(terms, k=k, sweeps=3)


def mul_float_limbs(al: Sequence, b) -> list:
    """k-limb * plain-float tensor, exact partial products through limb k-2."""
    al = list(al)
    b = torch.as_tensor(b, dtype=al[0].dtype, device=al[0].device)
    terms = []
    for l in al[:-1]:
        terms.extend(two_prod_terms(l, b))
    terms.append(al[-1] * b)
    return renorm_list(terms, k=len(al), sweeps=3)


def mul_pow2_limbs(al: Sequence, s) -> list:
    """Exact scaling by a power of two."""
    return [l * s for l in al]


def fma_limbs(acc: Sequence, al: Sequence, bl: Sequence) -> list:
    return add_limbs(list(acc), mul_limbs(al, bl))


def div_limbs(al: Sequence, bl: Sequence) -> list:
    """Long division at k limbs: k+1 native-quotient correction rounds."""
    al, bl = list(al), list(bl)
    k = len(al)
    q_terms = []
    r = al
    for _ in range(k + 1):
        qi = r[0] / bl[0]
        q_terms.append(qi)
        r = add_limbs(r, neg_limbs(mul_float_limbs(bl, qi)))
    return renorm_list(q_terms, k=k, sweeps=3)


def to_dd_limbs(ls: Sequence):
    """(hi, lo) double-word rounding of a k-limb expansion."""
    ls = list(ls)
    s, e = quick_two_sum(ls[0], ls[1])
    if len(ls) > 2:
        tail = ls[2]
        for t in ls[3:]:
            tail = tail + t
        e = e + tail
    return quick_two_sum(s, e)


def sqrt_limbs(al: Sequence) -> list:
    """k-limb sqrt: DD seed (~106 bits) + one Heron step s <- (s + a/s)/2."""
    from . import dd as _dd

    al = list(al)
    k = len(al)
    sd = _dd.sqrt(_dd.DD(*to_dd_limbs(al)))
    z = torch.zeros_like(al[0])
    s0 = [sd.hi, sd.lo] + [z] * (k - 2)
    s = mul_pow2_limbs(add_limbs(s0, div_limbs(al, s0)), 0.5)
    zero = al[0] == 0
    return [torch.where(zero, torch.zeros_like(l), l) for l in s]


def sum_limbs(al: Sequence, axis=None, keepdims=False) -> list:
    """Compensated reduction along an axis by repeated halving."""
    al = list(al)
    if axis is None:
        return sum_limbs([l.reshape(-1) for l in al], axis=0,
                         keepdims=keepdims)
    cur = [torch.movedim(l, axis, 0) for l in al]
    m = cur[0].shape[0]
    while m > 1:
        half = m // 2
        even = [l[: 2 * half : 2] for l in cur]
        odd = [l[1 : 2 * half : 2] for l in cur]
        red = add_limbs(even, odd)
        if m % 2:
            tail = [torch.cat([l[-1:], torch.zeros_like(r[1:])], 0)
                    for l, r in zip(cur, red)]
            red = add_limbs(red, tail)
        cur = red
        m = half
    out = [l[0] for l in cur]
    if keepdims:
        out = [l.unsqueeze(axis) for l in out]
    return out
