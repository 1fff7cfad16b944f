"""The elementwise multi-limb operations as one kernel launch each.

``mp.add``/``sub``/``mul``/``fma``/``div``/``sqrt``/``mul_float`` on CUDA
tensors come here (``core.mp`` dispatches), and so does ``mp.sum_``'s
halving tree, one launch per reduction.  The reference runs its tier
arithmetic jitted, fused by XLA into one loop per call
(``repro/core/sdp.py``'s ``_ml_*`` helpers, the jitted linear algebra and
refinement steps); eagerly, one qd ``mp.mul`` is some two thousand
PyTorch operations and one qd ``mp.div`` some seven thousand, so the SDP
loop's small sequential factorizations and triangular solves would be
bound by launch overhead.  On a CUDA tensor the wrapper launches the
hand-written kernel ``csrc/mpops.cu`` at the operands' limb count; on a
CPU tensor it runs ``mpops_plain``, the tier modules' own PyTorch code.
The two agree bit for bit on the card.

Operands broadcast as PyTorch does; the kernel reads each one through its
own strides (0 on a broadcast dim), so broadcasts and sliced views are
never copied.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import mp
from . import _build

__all__ = ["OPS", "mpops_call", "mpops_plain", "sum_", "sum_plain",
           "launches"]

OPS = {"add": 0, "sub": 1, "mul": 2, "fma": 3, "div": 4, "sqrt": 5,
       "mul_float": 6}

# launches of the CUDA kernel in this process per limb count (never of the
# plain version)
launches = dict.fromkeys(_build.LIMBS, 0)

_FNS: dict = {}


def mpops_plain(op, *args):
    """The tier module's own PyTorch version of ``op`` (no dispatch)."""
    return getattr(mp.tier_module(args[0]), op)(*args)


def _fn(nl):
    fn = _FNS.get(nl)
    if fn is None:
        fn = _build.load("mpops", nl).mpops
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9
        fn.restype = ctypes.c_int
        _FNS[nl] = fn
    return fn


DIMS = 4  # the kernel's index rank


def _strides(ls, shape):
    """The operand's element strides over the padded output shape (0 on
    broadcast dims), reading the limbs where they lie; a limb set whose
    layouts differ is made contiguous first."""
    if len({l.stride() for l in ls}) != 1:
        ls = [l.contiguous() for l in ls]
    lead = ls[0]
    pad = DIMS - lead.dim()
    st = [0] * DIMS
    for d in range(lead.dim()):
        if lead.shape[d] != 1:
            st[pad + d] = lead.stride(d)
    return ls, (ctypes.c_longlong * DIMS)(*st)


def _launch(op, values):
    """Launch ``op`` over the broadcast shape; return the output limbs."""
    lists = [mp.limbs(v) if not isinstance(v, torch.Tensor) else [v]
             for v in values]
    shapes = [tuple(ls[0].shape) for ls in lists]
    shape = shapes[0] if all(sh == shapes[0] for sh in shapes) \
        else tuple(np.broadcast_shapes(*shapes))
    nl = len(lists[0])
    dev = lists[0][0].device
    for ls in lists:
        if ls[0].dtype != torch.float64 or ls[0].device != dev:
            raise ValueError(f"the multi-limb kernels take float64 limbs on "
                             f"{dev}, got {ls[0].dtype} on {ls[0].device}")
    if len(shape) > DIMS:  # beyond the kernel's rank: flat contiguous
        lists = [[torch.broadcast_to(l, shape).reshape(-1) for l in ls]
                 for ls in lists]
    flat = lists[0][0].shape if len(shape) > DIMS else shape
    args = []
    for ls in lists:
        ls, st = _strides(ls, flat)
        args.append((ls, _build.pointers(ls), st))
    out = [torch.empty(shape, dtype=torch.float64, device=dev)
           for _ in range(nl)]
    if out[0].numel() == 0:
        return out
    dims = (ctypes.c_longlong * DIMS)(
        *((1,) * (DIMS - len(flat)) + tuple(flat)))
    ptrs = [a[1:] for a in args] + [(None, None)] * (3 - len(args))
    err = _fn(nl)(OPS[op], *ptrs[0], *ptrs[1], *ptrs[2],
                  _build.pointers(out), dims, _build.stream(dev))
    if err:
        raise RuntimeError(f"mpops {op} at {nl} limbs failed: CUDA error "
                           f"{err}")
    launches[nl] += 1
    return out


def mpops_call(op, *args):
    """``op`` on tier values (``mul_float``'s second argument: a float or
    an f64 tensor).  CUDA operands launch the kernel and never fall back;
    CPU operands run the plain version."""
    lead = mp.limbs(args[0])[0]
    if lead.device.type != "cuda":
        return mpops_plain(op, *args)
    if op == "mul_float":
        args = (args[0], torch.as_tensor(args[1], dtype=torch.float64,
                                         device=lead.device))
    return mp.from_limbs(_launch(op, args))


def sum_plain(a, axis=None, keepdims=False):
    """The tier module's own PyTorch ``sum_`` (no dispatch)."""
    return mp.tier_module(a).sum_(a, axis=axis, keepdims=keepdims)


def sum_(a, axis=None, keepdims=False):
    """``mp.sum_`` in one launch on a CUDA tensor: the tier modules'
    halving tree (pairs (0,1), (2,3), ...; an odd tail added onto the first
    partial through a zero-padded row), level by level inside the kernel.
    CPU tensors run the plain version."""
    lead = mp.limbs(a)[0]
    if lead.device.type != "cuda":
        return sum_plain(a, axis=axis, keepdims=keepdims)
    if axis is None:
        return sum_(a.reshape(-1), axis=0, keepdims=keepdims)
    if lead.dtype != torch.float64:
        raise ValueError(f"the multi-limb kernels take float64 limbs, got "
                         f"{lead.dtype}")
    xs = [torch.movedim(l, axis, 0) for l in mp.limbs(a)]
    length, rest = xs[0].shape[0], tuple(xs[0].shape[1:])
    if length == 0:
        raise ValueError("sum_ over an empty axis")
    cols = int(np.prod(rest))
    out = _sum_launch([x.reshape(length, cols).contiguous() for x in xs])
    res = mp.from_limbs([o.reshape(rest) for o in out])
    if keepdims:
        res = mp.map_limbs(lambda l: l.unsqueeze(axis), res)
    return res


def _sum_launch(xs):
    """Launch the halving-tree sum over the rows of contiguous (L, N)
    limbs; returns the (1, N) output limbs."""
    length, cols = xs[0].shape
    dev = xs[0].device
    half = length // 2

    def scratch(rows):
        return [torch.empty((rows, cols), dtype=torch.float64, device=dev)
                for _ in xs]

    s0, s1, out = scratch(half), scratch(max(half // 2, 1)), scratch(1)
    err = _sum_fn(len(xs))(
        _build.pointers(xs), _build.pointers(s0), _build.pointers(s1),
        _build.pointers(out), length, cols, _build.stream(dev))
    if err:
        raise RuntimeError(f"mpops sum at {len(xs)} limbs failed: CUDA "
                           f"error {err}")
    launches[len(xs)] += 1
    return out


_SUM_FNS: dict = {}


def _sum_fn(nl):
    fn = _SUM_FNS.get(nl)
    if fn is None:
        fn = _build.load("mpops", nl).mpops_sum
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _SUM_FNS[nl] = fn
    return fn
