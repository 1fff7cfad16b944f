"""Kernel #1: the systolic-tile multi-limb GEMM (the ``pallas`` backend).

The port of ``repro.kernels.mlgemm``.  Per output element the reference
folds k = 0..K-1 in order, ``acc = mp.fma(acc, a[i, k], b[k, j])`` from a
zero accumulator: the paper's PE array, whose bits depend on no block
size.  On a CUDA tensor the wrapper launches the hand-written Hopper
kernel ``csrc/mlgemm.cu`` (dd only; see that file for its design and
bound); on a CPU tensor it runs ``mlgemm_plain``, the same waves as
tensor ops in the same order, at any registered limb count.  The two
agree bit for bit on the card (``chip_smoke.py`` holds them to it).
"""

from __future__ import annotations

import ctypes

import torch

from .._device import common_device
from ..core import mp
from . import _build

__all__ = ["mlgemm_kernel_call", "mlgemm_plain", "launches"]

# launches of the CUDA kernel in this process (never of the plain version)
launches = 0


def mlgemm_plain(a, b):
    """C = A @ B at the operands' tier: the K-ordered FMA fold, as tensor
    ops (the plain PyTorch version of the kernel)."""
    m, k = a.shape
    n = b.shape[1]
    lead = mp.limbs(a)[0]
    acc = mp.zeros((m, n), mp.precision_of(a), dtype=lead.dtype,
                   device=lead.device)
    for kk in range(k):
        acc = mp.fma(acc, mp.map_limbs(lambda l: l[:, kk:kk + 1], a),
                     mp.map_limbs(lambda l: l[kk:kk + 1, :], b))
    return acc


def _check(limbs):
    if len(limbs) % 2:
        raise ValueError(f"expected nlimbs A limbs + nlimbs B limbs, got "
                         f"{len(limbs)} tensors")
    nl = len(limbs) // 2
    mp.precision_for_count(nl)  # raises on an unregistered count
    dev = common_device(*limbs)
    for l in limbs:
        if l.dtype != torch.float64 or l.dim() != 2 or not l.is_contiguous():
            raise ValueError("kernel operands must be contiguous 2-D "
                             f"float64 tensors, got {l.dtype} "
                             f"{tuple(l.shape)} contiguous={l.is_contiguous()}")
    a_l, b_l = limbs[:nl], limbs[nl:]
    if len({tuple(l.shape) for l in a_l}) != 1 or \
            len({tuple(l.shape) for l in b_l}) != 1 or \
            a_l[0].shape[1] != b_l[0].shape[0]:
        raise ValueError(f"shape mismatch: A limbs "
                         f"{[tuple(l.shape) for l in a_l]}, B limbs "
                         f"{[tuple(l.shape) for l in b_l]}")
    return nl, dev


def _launch(a_hi, a_lo, b_hi, b_lo):
    global launches
    m, k = a_hi.shape
    n = b_hi.shape[1]
    out = [torch.empty((m, n), dtype=torch.float64, device=a_hi.device)
           for _ in range(2)]
    if m == 0 or n == 0:
        return out
    fn = _build.load("mlgemm").mlgemm_dd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(a_hi.device).cuda_stream
    err = fn(a_hi.data_ptr(), a_lo.data_ptr(), b_hi.data_ptr(),
             b_lo.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
             m, n, k, stream)
    if err:
        raise RuntimeError(f"mlgemm_dd launch failed: CUDA error {err}")
    launches += 1
    return out


def mlgemm_kernel_call(*limbs):
    """C = A @ B on nlimbs A limbs (m, k) + nlimbs B limbs (k, n).

    Any shape (ragged edges are the kernel's own business).  Returns the
    nlimbs output limbs.  CUDA tensors launch the kernel (dd only; td/qd
    raise NotImplementedError) and never fall back; CPU tensors run the
    plain version.
    """
    nl, dev = _check(limbs)
    if dev.type == "cuda":
        if nl != 2:
            raise NotImplementedError(
                f"the CUDA systolic kernel is dd only; {nl} planes are "
                f"still to port (ROADMAP.md, 'TPU kernels to port')")
        return _launch(*limbs)
    a = mp.from_limbs(limbs[:nl])
    b = mp.from_limbs(limbs[nl:])
    return mp.limbs(mlgemm_plain(a, b))
