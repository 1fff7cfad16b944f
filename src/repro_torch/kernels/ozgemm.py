"""Kernel #2: the fused Ozaki-slice GEMM (the ``ozaki-pallas`` backend).

The port of ``repro.kernels.ozgemm``.  Per K slab of the plan's depth
``bk``: slice the A and B slabs on their slab-local anchor ladders
(``core.ozaki._extract_slices``), sum each diagonal's pair dots exactly in
f64, fold each diagonal into the dd accumulator with ``add_float``; the
drain applies the Rgemm epilogue (``none`` | ``alpha`` | ``full``, with
the beta == 0 select).  On a CUDA tensor the wrapper launches the
hand-written Hopper kernel ``csrc/ozgemm.cu`` (see that file for its
design and bound); on a CPU tensor it runs ``ozgemm_plain``, the same
algorithm as tensor ops.  The two agree bit for bit on the card.

Only dd at f64 slices / f64 accumulation is supported, on both devices:
narrow slice dtypes and the td/qd folds are still to port, and the
wrapper raises on them rather than take a path the kernel does not have.
"""

from __future__ import annotations

import ctypes

import torch

from .._device import common_device
from ..core import dd, mp
from ..core.ozaki import _extract_slices, diagonal_sums
from . import _build

__all__ = ["ozgemm_kernel_call", "ozgemm_plain", "EPILOGUES", "launches"]

EPILOGUES = ("none", "alpha", "full")

# launches of the CUDA kernel in this process (never of the plain version)
launches = 0


def _slab_update(acc, a, b, *, beta, n_slices, full):
    """One K slab: extract slices, run the diagonal dots, fold into acc."""
    sa = _extract_slices(a, beta, n_slices, axis=1)
    sb = _extract_slices(b, beta, n_slices, axis=0)
    for _, dsum in diagonal_sums(sa, sb, n_slices, full, torch.float64):
        acc = dd.add_float(acc, dsum)
    return acc


def apply_epilogue(res, alpha=None, beta=None, c=None):
    """alpha * res [+ beta * c], beta == 0 selecting zero (C not read)."""
    if alpha is not None:
        res = mp.mul(mp.broadcast_to(alpha, res.shape), res)
    if c is not None:
        bc = mp.mul(mp.broadcast_to(beta, c.shape), c)
        bc = mp.where(torch.broadcast_to(mp.is_zero(beta), bc.shape),
                      mp.map_limbs(torch.zeros_like, bc), bc)
        res = mp.add(res, bc)
    return res


def ozgemm_plain(a, b, *, bk, beta, n_slices, full=False, alpha=None,
                 beta_s=None, c=None):
    """The kernel's algorithm as tensor ops (dd values in, dd value out)."""
    m, k = a.shape
    n = b.shape[1]
    acc = dd.zeros((m, n), dtype=a.hi.dtype, device=a.hi.device)
    for k0 in range(0, k, bk):
        acc = _slab_update(acc, a[:, k0:k0 + bk], b[k0:k0 + bk, :],
                           beta=beta, n_slices=n_slices, full=full)
    return apply_epilogue(acc, alpha, beta_s, c)


def _split_operands(operands, epilogue):
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; one of {EPILOGUES}")
    per_limb = {"none": 2, "alpha": 3, "full": 5}[epilogue]
    nl, rem = divmod(len(operands), per_limb)
    if rem or nl not in mp.PRECISIONS.values():
        raise ValueError(f"{len(operands)} operands do not fit epilogue "
                         f"{epilogue!r}")
    if nl != 2:
        raise NotImplementedError(
            f"the fused Ozaki kernel is dd only; the {nl}-limb fold is "
            f"still to port (ROADMAP.md, 'TPU kernels to port')")
    groups = [operands[i:i + 2] for i in range(0, len(operands), 2)]
    a, b = groups[0], groups[1]
    alpha = groups[2] if epilogue != "none" else None
    beta_s, c = (groups[3], groups[4]) if epilogue == "full" else (None, None)
    return a, b, alpha, beta_s, c


def _check(operands, a, b, alpha, beta_s, c):
    dev = common_device(*operands)
    for l in operands:
        if l.dtype != torch.float64 or l.dim() != 2 or not l.is_contiguous():
            raise ValueError("kernel operands must be contiguous 2-D "
                             f"float64 tensors, got {l.dtype} "
                             f"{tuple(l.shape)} contiguous={l.is_contiguous()}")
    m, k = a[0].shape
    n = b[0].shape[1]
    want = [(m, k)] * 2 + [(k, n)] * 2
    got = [tuple(l.shape) for l in (*a, *b)]
    for pair in (alpha, beta_s):
        if pair is not None:
            want += [(1, 1)] * 2
            got += [tuple(l.shape) for l in pair]
    if c is not None:
        want += [(m, n)] * 2
        got += [tuple(l.shape) for l in c]
    if got != want:
        raise ValueError(f"operand shapes {got} do not match {want}")
    return dev


def _launch(a, b, alpha, beta_s, c, *, bk, beta, n_slices, n_diag, epi):
    global launches
    m, k = a[0].shape
    n = b[0].shape[1]
    dev = a[0].device
    out = [torch.empty((m, n), dtype=torch.float64, device=dev)
           for _ in range(2)]
    if m == 0 or n == 0:
        return out
    # the drain reads each scalar as {hi, lo} from one 2-element buffer
    sc_alpha = torch.cat([l.reshape(1) for l in alpha]) if alpha else None
    sc_beta = torch.cat([l.reshape(1) for l in beta_s]) if beta_s else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.load("ozgemm")
    fn = lib.ozgemm_dd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(a[0].data_ptr(), a[1].data_ptr(), b[0].data_ptr(),
             b[1].data_ptr(), ptr(sc_alpha), ptr(sc_beta),
             ptr(c[0] if c else None), ptr(c[1] if c else None),
             out[0].data_ptr(), out[1].data_ptr(), m, n, k, bk, beta,
             n_slices, n_diag, EPILOGUES.index(epi), stream)
    if err:
        smem = lib.ozgemm_dd_smem_bytes(bk, n_slices)
        raise RuntimeError(
            f"ozgemm_dd launch failed: CUDA error {err} (bk={bk} x "
            f"n_slices={n_slices} asks {smem} B of shared memory per block; "
            f"Hopper allows 232448)")
    launches += 1
    return out


def ozgemm_kernel_call(*operands, bk: int, beta: int, n_slices: int,
                       slice_dtype_name: str = "float64",
                       acc_dtype_name: str = "float64",
                       epilogue: str = "none", full: bool = False):
    """Raw kernel invocation.

    ``operands``: 2 A limbs (m, k) + 2 B limbs (k, n); with
    ``epilogue="alpha"`` also 2 (1, 1) alpha limbs; with ``"full"``
    additionally 2 (1, 1) beta limbs and 2 (m, n) C limbs.  ``bk``,
    ``beta`` and ``n_slices`` are the plan's solved values.  Any shape:
    ragged edges are the kernel's own business.  Returns [out_hi, out_lo].
    """
    if slice_dtype_name != "float64" or acc_dtype_name != "float64":
        raise NotImplementedError(
            f"slices {slice_dtype_name} / accumulator {acc_dtype_name}: the "
            f"fused Ozaki kernel takes f64/f64 only; narrow slice dtypes "
            f"are still to port (ROADMAP.md, 'TPU kernels to port')")
    a, b, alpha, beta_s, c = _split_operands(operands, epilogue)
    dev = _check(operands, a, b, alpha, beta_s, c)
    if bk < 1 or not 1 <= n_slices <= 16:
        raise ValueError(f"bk={bk}, n_slices={n_slices} out of range")
    if dev.type == "cuda":
        n_diag = 2 * n_slices - 1 if full else n_slices
        return _launch(a, b, alpha, beta_s, c, bk=bk, beta=beta,
                       n_slices=n_slices, n_diag=n_diag, epi=epilogue)

    def val(pair):
        return None if pair is None else dd.DD(*pair)

    out = ozgemm_plain(dd.DD(*a), dd.DD(*b), bk=bk, beta=beta,
                       n_slices=n_slices, full=full, alpha=val(alpha),
                       beta_s=val(beta_s), c=val(c))
    return mp.limbs(out)
