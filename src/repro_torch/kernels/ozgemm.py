"""Kernel #2: the fused Ozaki-slice GEMM (the ``ozaki-pallas`` backend).

The port of ``repro.kernels.ozgemm``.  Per K slab of the plan's depth
``bk``: slice the A and B slabs on their slab-local anchor ladders
(``core.ozaki._extract_slices``), sum each diagonal's pair dots exactly in
f64, fold each diagonal into the k-limb accumulator (``dd.add_float`` at
dd, ``renorm_list(acc + [dsum], k, sweeps=3)`` at td/qd); the drain
applies the Rgemm epilogue (``none`` | ``alpha`` | ``full``, with the
beta == 0 select) at k limbs.  On a CUDA tensor the wrapper launches the
hand-written Hopper kernel ``csrc/ozgemm.cu`` at 2, 3 or 4 limbs (see
that file for its design and bound); on a CPU tensor it runs
``ozgemm_plain``, the same algorithm as tensor ops.  The two agree bit for
bit on the card.

A, B and C may carry one leading batch axis (an operand without it is
shared); on the card the batch is the kernel's third grid axis.  Only f64
slices and f64 accumulation are supported, on both devices: the narrow
slice dtypes are the TPU's MXU variant, still to port, and the wrapper
raises on them rather than take a path the kernel does not have.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._device import common_device
from ..core import mp
from ..core.ozaki import _extract_slices, _fold_diagonal_sum, diagonal_sums
from . import _build

__all__ = ["ozgemm_kernel_call", "ozgemm_plain", "EPILOGUES", "launches",
           "SMEM_LIMIT"]

EPILOGUES = ("none", "alpha", "full")

# launches of the CUDA kernel in this process per limb count (never of the
# plain version)
launches = dict.fromkeys(_build.LIMBS, 0)

# shared memory one Hopper block may opt in to, and the batch grid limit
SMEM_LIMIT = 232448
MAX_BATCH = 65535


def _slab_update(acc, a, b, *, beta, n_slices, full):
    """One K slab: extract slices, run the diagonal dots, fold into acc."""
    tier = mp.tier_module(a)
    sa = _extract_slices(a, beta, n_slices, axis=-1, ops=tier)
    sb = _extract_slices(b, beta, n_slices, axis=-2, ops=tier)
    for _, dsum in diagonal_sums(sa, sb, n_slices, full, torch.float64):
        acc = _fold_diagonal_sum(acc, dsum)
    return acc


def apply_epilogue(res, alpha=None, beta=None, c=None, ops=mp):
    """alpha * res [+ beta * c], beta == 0 selecting zero (C not read).
    ``ops``: ``mp`` (kernel launches on the card) or a tier module (the
    plain version)."""
    if alpha is not None:
        res = ops.mul(mp.broadcast_to(alpha, res.shape), res)
    if c is not None:
        bc = ops.mul(mp.broadcast_to(beta, c.shape), c)
        bc = ops.where(torch.broadcast_to(mp.is_zero(beta), bc.shape),
                       mp.map_limbs(torch.zeros_like, bc), bc)
        res = ops.add(res, bc)
    return res


def ozgemm_plain(a, b, *, bk, beta, n_slices, full=False, alpha=None,
                 beta_s=None, c=None):
    """The kernel's algorithm as tensor ops (tier values in, tier value
    out; leading batch dims broadcast): the tier module's arithmetic, no
    kernel launch on any device."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    batch = np.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    lead = mp.limbs(a)[0]
    acc = mp.zeros(batch + (m, n), mp.precision_of(a), dtype=lead.dtype,
                   device=lead.device)
    for k0 in range(0, k, bk):
        acc = _slab_update(acc, a[..., k0:k0 + bk], b[..., k0:k0 + bk, :],
                           beta=beta, n_slices=n_slices, full=full)
    return apply_epilogue(acc, alpha, beta_s, c, ops=mp.tier_module(a))


def _split_operands(operands, epilogue):
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; one of {EPILOGUES}")
    per_limb = {"none": 2, "alpha": 3, "full": 5}[epilogue]
    nl, rem = divmod(len(operands), per_limb)
    if rem or nl not in mp.PRECISIONS.values():
        raise ValueError(f"{len(operands)} operands do not fit epilogue "
                         f"{epilogue!r}")
    groups = [operands[i:i + nl] for i in range(0, len(operands), nl)]
    a, b = groups[0], groups[1]
    alpha = groups[2] if epilogue != "none" else None
    beta_s, c = (groups[3], groups[4]) if epilogue == "full" else (None, None)
    return nl, a, b, alpha, beta_s, c


def _check(operands, a, b, alpha, beta_s, c):
    dev = common_device(*operands)
    for l in operands:
        if l.dtype != torch.float64 or l.dim() not in (2, 3) \
                or not l.is_contiguous():
            raise ValueError("kernel operands must be contiguous 2-D or 3-D "
                             f"float64 tensors, got {l.dtype} "
                             f"{tuple(l.shape)} contiguous={l.is_contiguous()}")
    m, k = a[0].shape[-2:]
    n = b[0].shape[-1]
    batches = {l.shape[0] for l in (*a, *b, *(c or ())) if l.dim() == 3}
    if len(batches) > 1:
        raise ValueError(f"batch sizes differ: {sorted(batches)}")
    batch = batches.pop() if batches else None
    if batch is not None and batch > MAX_BATCH:
        raise ValueError(f"batch {batch} exceeds the kernel's grid limit "
                         f"{MAX_BATCH}")

    def want(shape, ls):
        return [shape if l.dim() == 2 else (batch,) + shape for l in ls]

    want_s = want((m, k), a) + want((k, n), b)
    got = [tuple(l.shape) for l in (*a, *b)]
    for pair in (alpha, beta_s):
        if pair is not None:
            want_s += [(1, 1)] * len(pair)
            got += [tuple(l.shape) for l in pair]
    if c is not None:
        want_s += want((m, n), c)
        got += [tuple(l.shape) for l in c]
    if got != want_s:
        raise ValueError(f"operand shapes {got} do not match {want_s}")
    return dev, batch


def smem_bytes(nl, bk, n_slices):
    """Shared memory one CTA asks for (as ``ozgemm_smem_bytes``)."""
    return _build.load("ozgemm", nl).ozgemm_smem_bytes(bk, n_slices)


def _launch(nl, a, b, alpha, beta_s, c, batch, *, bk, beta, n_slices,
            n_diag, epi):
    m, k = a[0].shape[-2:]
    n = b[0].shape[-1]
    dev = a[0].device
    lead = (batch,) if batch is not None else ()
    out = [torch.empty(lead + (m, n), dtype=torch.float64, device=dev)
           for _ in range(nl)]
    if m == 0 or n == 0 or batch == 0:
        return out
    smem = smem_bytes(nl, bk, n_slices)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"bk={bk} x n_slices={n_slices} at {nl} limbs asks {smem} B of "
            f"shared memory per block; Hopper allows {SMEM_LIMIT}")
    # the drain reads each scalar's limbs from one buffer
    sc_alpha = torch.cat([l.reshape(1) for l in alpha]) if alpha else None
    sc_beta = torch.cat([l.reshape(1) for l in beta_s]) if beta_s else None

    def stride(ls, per):
        return per if ls and ls[0].dim() == 3 else 0

    fn = _build.load("ozgemm", nl).ozgemm
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
        [ctypes.c_longlong] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_build.pointers(a), _build.pointers(b),
             None if sc_alpha is None else sc_alpha.data_ptr(),
             None if sc_beta is None else sc_beta.data_ptr(),
             _build.pointers(c or [None] * nl), _build.pointers(out),
             m, n, k, batch or 1, stride(a, m * k), stride(b, k * n),
             stride(c, m * n), bk, beta, n_slices, n_diag,
             EPILOGUES.index(epi), _build.stream(dev))
    if err:
        raise RuntimeError(
            f"ozgemm launch at {nl} limbs failed: CUDA error {err} (bk={bk} "
            f"x n_slices={n_slices} asks {smem} B of shared memory per "
            f"block)")
    launches[nl] += 1
    return out


def ozgemm_kernel_call(*operands, bk: int, beta: int, n_slices: int,
                       slice_dtype_name: str = "float64",
                       acc_dtype_name: str = "float64",
                       epilogue: str = "none", full: bool = False):
    """Raw kernel invocation.

    ``operands``: nlimbs A limbs (m, k) + nlimbs B limbs (k, n), nlimbs =
    2, 3 or 4; with ``epilogue="alpha"`` also nlimbs (1, 1) alpha limbs;
    with ``"full"`` additionally nlimbs (1, 1) beta limbs and nlimbs (m, n)
    C limbs.  A, B and C limbs may carry a leading batch axis (nb, ...);
    without it an operand is shared.  ``bk``, ``beta`` and ``n_slices`` are
    the plan's solved values.  Any shape: ragged edges are the kernel's own
    business.  Returns the nlimbs output limbs.
    """
    if slice_dtype_name != "float64" or acc_dtype_name != "float64":
        raise NotImplementedError(
            f"slices {slice_dtype_name} / accumulator {acc_dtype_name}: the "
            f"fused Ozaki kernel takes f64/f64 only; narrow slice dtypes "
            f"are still to port (ROADMAP.md, 'TPU kernels to port')")
    nl, a, b, alpha, beta_s, c = _split_operands(operands, epilogue)
    dev, batch = _check(operands, a, b, alpha, beta_s, c)
    if bk < 1 or not 1 <= n_slices <= 16:
        raise ValueError(f"bk={bk}, n_slices={n_slices} out of range")
    if dev.type == "cuda":
        n_diag = 2 * n_slices - 1 if full else n_slices
        return _launch(nl, a, b, alpha, beta_s, c, batch, bk=bk, beta=beta,
                       n_slices=n_slices, n_diag=n_diag, epi=epilogue)

    def val(ls):
        return None if ls is None else mp.from_limbs(ls)

    out = ozgemm_plain(val(a), val(b), bk=bk, beta=beta, n_slices=n_slices,
                       full=full, alpha=val(alpha), beta_s=val(beta_s),
                       c=val(c))
    return mp.limbs(out)
