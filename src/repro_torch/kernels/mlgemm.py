"""Kernel #1: the systolic-tile multi-limb GEMM (the ``pallas`` backend).

The port of ``repro.kernels.mlgemm``.  Per output element the reference
folds k = 0..K-1 in order, ``acc = mp.fma(acc, a[i, k], b[k, j])`` from a
zero accumulator: the paper's PE array, whose bits depend on no block
size.  On a CUDA tensor the wrapper launches the hand-written Hopper
kernel ``csrc/mlgemm.cu`` at 2, 3 or 4 limb planes (see that file for its
design and bound); on a CPU tensor it runs ``mlgemm_plain``, the same
waves as tensor ops in the same order.  The two agree bit for bit on the
card (``chip_smoke.py`` holds them to it).

Either operand may carry one leading batch axis, (nb, m, k) / (nb, k, n);
an operand without it is shared by every batch entry.  On the card the
batch is the kernel's third grid axis, so a batched call is one launch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._device import common_device
from ..core import mp
from . import _build

__all__ = ["mlgemm_kernel_call", "mlgemm_plain", "launches"]

# launches of the CUDA kernel in this process per limb count (never of the
# plain version)
launches = dict.fromkeys(_build.LIMBS, 0)

# grid limit of the batch axis (gridDim.z)
MAX_BATCH = 65535


def mlgemm_plain(a, b):
    """C = A @ B at the operands' tier: the K-ordered FMA fold, as tensor
    ops (the plain PyTorch version of the kernel: the tier module's
    arithmetic, no kernel launch on any device).  Leading batch dims
    broadcast."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    batch = np.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    lead = mp.limbs(a)[0]
    acc = mp.zeros(batch + (m, n), mp.precision_of(a), dtype=lead.dtype,
                   device=lead.device)
    fma = mp.tier_module(a).fma
    for kk in range(k):
        acc = fma(acc, mp.map_limbs(lambda l: l[..., kk:kk + 1], a),
                  mp.map_limbs(lambda l: l[..., kk:kk + 1, :], b))
    return acc


def _check(limbs):
    if len(limbs) % 2:
        raise ValueError(f"expected nlimbs A limbs + nlimbs B limbs, got "
                         f"{len(limbs)} tensors")
    nl = len(limbs) // 2
    mp.precision_for_count(nl)  # raises on an unregistered count
    dev = common_device(*limbs)
    for l in limbs:
        if l.dtype != torch.float64 or l.dim() not in (2, 3) \
                or not l.is_contiguous():
            raise ValueError("kernel operands must be contiguous 2-D or 3-D "
                             f"float64 tensors, got {l.dtype} "
                             f"{tuple(l.shape)} contiguous={l.is_contiguous()}")
    a_l, b_l = limbs[:nl], limbs[nl:]
    sa, sb = {tuple(l.shape) for l in a_l}, {tuple(l.shape) for l in b_l}
    if len(sa) != 1 or len(sb) != 1:
        raise ValueError(f"limb shapes differ: A {sorted(sa)}, B {sorted(sb)}")
    (sa,), (sb,) = sa, sb
    ba, bb = sa[:-2], sb[:-2]
    if sa[-1] != sb[-2] or (ba and bb and ba != bb):
        raise ValueError(f"shape mismatch: A limbs {sa}, B limbs {sb}")
    batch = (ba or bb or (None,))[0]
    if batch is not None and batch > MAX_BATCH:
        raise ValueError(f"batch {batch} exceeds the kernel's grid limit "
                         f"{MAX_BATCH}")
    return nl, dev, batch


def _launch(a_l, b_l, nl, batch):
    m, k = a_l[0].shape[-2:]
    n = b_l[0].shape[-1]
    lead = (batch,) if batch is not None else ()
    out = [torch.empty(lead + (m, n), dtype=torch.float64,
                       device=a_l[0].device) for _ in range(nl)]
    if m == 0 or n == 0 or batch == 0:
        return out
    fn = _build.load("mlgemm", nl).mlgemm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
        [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sa = m * k if a_l[0].dim() == 3 else 0
    sb = k * n if b_l[0].dim() == 3 else 0
    err = fn(_build.pointers(a_l), _build.pointers(b_l),
             _build.pointers(out), m, n, k, batch or 1, sa, sb,
             _build.stream(a_l[0].device))
    if err:
        raise RuntimeError(f"mlgemm launch at {nl} limbs failed: CUDA "
                           f"error {err}")
    launches[nl] += 1
    return out


def mlgemm_kernel_call(*limbs):
    """C = A @ B on nlimbs A limbs + nlimbs B limbs (nlimbs = 2, 3 or 4).

    A limbs are (m, k) or (nb, m, k), B limbs (k, n) or (nb, k, n); an
    operand without the batch axis is shared.  Any shape (ragged edges are
    the kernel's own business).  Returns the nlimbs output limbs, (m, n)
    or (nb, m, n).  CUDA tensors launch the kernel and never fall back;
    CPU tensors run the plain version.
    """
    nl, dev, batch = _check(limbs)
    if dev.type == "cuda":
        return _launch(limbs[:nl], limbs[nl:], nl, batch)
    a = mp.from_limbs(limbs[:nl])
    b = mp.from_limbs(limbs[nl:])
    return mp.limbs(mlgemm_plain(a, b))
