"""Kernel #2: the fused Ozaki-slice GEMM (the ``ozaki-pallas`` backend).

The port of ``repro.kernels.ozgemm``.  Per K slab of the plan's depth
``bk``: slice the A and B slabs on their slab-local anchor ladders
(``core.ozaki._extract_slices``); with narrow slices, normalize them into
the slice type per row of A and per column of B
(``core.ozaki._normalize_slices``); sum each diagonal's pair dots exactly
in the accumulator type; rescale a narrow diagonal by ``(sc_a * sc_b) *
2^(-d*beta)``; fold each diagonal into the k-limb accumulator
(``dd.add_float`` at dd, ``renorm_list(acc + [dsum], k, sweeps=3)`` at
td/qd).  The drain applies the Rgemm epilogue (``none`` | ``alpha`` |
``full``, with the beta == 0 select) at k limbs.

On a CUDA tensor the wrapper launches a hand-written Hopper kernel at 2, 3
or 4 limbs: ``csrc/ozgemm.cu`` for f64 slices, ``csrc/ozgemm_narrow.cu``
for narrow ones (bf16 pair dots on the tensor cores); see those files for
their design and bound.  On a CPU tensor it runs ``ozgemm_plain``, the
same algorithm as tensor ops.  The two agree bit for bit on the card.

The (slice, accumulator) pairs are the ones the reference's kernel takes
from a plan (``SLICE_PAIRS``): f64/f64, bf16/f32, f32/f32, and bf16 or f32
slices with an f64 accumulator (what ``make_plan(slice_dtype=...)`` alone
gives: the plan keeps ``acc_dtype=None`` and the engine reads f64).  Any
other pair raises ``ValueError``, on both devices.

A, B and C may carry one leading batch axis (an operand without it is
shared); on the card the batch is the kernel's third grid axis.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._device import common_device
from ..core import mp
from ..core.ozaki import (_extract_slices, _fold_diagonal_sum,
                          _normalize_slices, as_dtype, diagonal_sums)
from . import _build

__all__ = ["ozgemm_kernel_call", "ozgemm_plain", "EPILOGUES", "launches",
           "SLICE_PAIRS", "VARIANTS", "SMEM_LIMIT", "smem_bytes"]

EPILOGUES = ("none", "alpha", "full")

# (slice dtype, accumulator dtype) -> the narrow kernel's variant number
# (csrc/ozgemm_narrow.cu), None for the f64-slice kernel (csrc/ozgemm.cu)
SLICE_PAIRS = {
    ("float64", "float64"): None,
    ("bfloat16", "float32"): 0,   # pair dots on the tensor cores
    ("float32", "float32"): 1,    # FFMA
    ("bfloat16", "float64"): 2,   # DFMA on the widened slices
    ("float32", "float64"): 3,
}
_SHORT = {"float64": "f64", "float32": "f32", "bfloat16": "bf16"}
VARIANTS = {v: f"{_SHORT[s]}/{_SHORT[a]}"
            for (s, a), v in SLICE_PAIRS.items() if v is not None}

# launches of the CUDA kernels in this process (never of the plain
# version): per limb count for f64 slices, and per (limb count,
# "slice/acc") for each narrow variant, e.g. launches[2, "bf16/f32"]
launches = dict.fromkeys(_build.LIMBS, 0)
launches.update({(nl, name): 0 for nl in _build.LIMBS
                 for name in VARIANTS.values()})

# shared memory one Hopper block may opt in to, and the batch grid limit
SMEM_LIMIT = 232448
MAX_BATCH = 65535
_TILE = 64 + 64  # rows of A plus columns of B per CTA
# what the plain version holds of a run of K slabs at once (bytes)
_PLAIN_RUN_BYTES = 1 << 30


def smem_bytes(bk, n_slices, slice_dtype_name="float64",
               acc_dtype_name="float64"):
    """Shared memory one CTA of the kernel asks for: ``oz::smem_bytes`` of
    ``csrc/oz_device.cuh``, the count both kernel builds launch with,
    repeated here so that CPU tensors are refused alike (chip_smoke.py
    holds the two equal on the card)."""
    variant = SLICE_PAIRS[slice_dtype_name, acc_dtype_name]
    if variant is None:
        return n_slices * bk * _TILE * 8 + _TILE * (8 + 1)
    kstride = -(-bk // 16) * 16 + 8
    elem = 4 if variant == 3 else 2
    return n_slices * _TILE * kstride * elem + _TILE * (3 * 8 + 1)


def _slab_diagonals(a, b, *, beta, n_slices, full, slice_dtype, acc_dtype):
    """Each diagonal's f64 sum for a run of K slabs at once, the slab axis
    first: a (c, ..., m, bk), b (c, ..., bk, n) -> [(c, ..., m, n)], most
    significant diagonal first (``repro.kernels.ozgemm._slab_update`` step
    for step, every slab on its own anchors and scales)."""
    tier = mp.tier_module(a)
    sa = _extract_slices(a, beta, n_slices, axis=-1, ops=tier)
    sb = _extract_slices(b, beta, n_slices, axis=-2, ops=tier)
    narrow = slice_dtype != torch.float64
    if narrow:
        # pair (s, t) then carries 2^(-(s+t)*beta): one rescale a diagonal
        sa, sc_a = _normalize_slices(sa, beta, -1, slice_dtype)
        sb, sc_b = _normalize_slices(sb, beta, -2, slice_dtype)
    out = []
    for d, dsum in diagonal_sums(sa, sb, n_slices, full, acc_dtype):
        if narrow:
            dsum = dsum.to(torch.float64) * (
                (sc_a * sc_b) * 2.0 ** (-d * beta))
        out.append(dsum)
    return out


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
                 beta_s=None, c=None, slice_dtype_name="float64",
                 acc_dtype_name="float64"):
    """The kernel's algorithm as tensor ops (tier values in, tier value
    out; leading batch dims broadcast): the tier module's arithmetic, no
    kernel launch on any device."""
    _pair(slice_dtype_name, acc_dtype_name)
    sdt, adt = as_dtype(slice_dtype_name), as_dtype(acc_dtype_name)
    m, k = a.shape[-2:]
    n = b.shape[-1]
    batch = np.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    lead = mp.limbs(a)[0]
    acc = mp.zeros(batch + (m, n), mp.precision_of(a), dtype=lead.dtype,
                   device=lead.device)
    # the K slabs as a leading axis, the ragged last one zero-padded (a
    # zero entry slices to zero and moves no maximum: the reference's
    # padding), so a run of slabs is sliced and dotted at once; the folds
    # stay in slab order
    pad, lead_dims = -k % bk, len(batch)

    def slabs(x, rows):
        def f(l):
            l = l.reshape((1,) * (lead_dims + 2 - l.dim()) + tuple(l.shape))
            if rows:  # (..., m, k) -> (nslab, ..., m, bk)
                l = torch.nn.functional.pad(l, (0, pad))
                return l.reshape(l.shape[:-1] + (-1, bk)).movedim(-2, 0)
            l = torch.nn.functional.pad(l, (0, 0, 0, pad))
            return l.reshape(l.shape[:-2] + (-1, bk, n)).movedim(-3, 0)
        return mp.map_limbs(f, x)

    a_s, b_s = slabs(a, True), slabs(b, False)
    n_diag = 2 * n_slices - 1 if full else n_slices
    per_slab = 8 * int(np.prod(batch)) * (n_diag * m * n
                                          + 2 * n_slices * (m + n) * bk)
    run = max(1, _PLAIN_RUN_BYTES // per_slab)
    for j0 in range(0, a_s.shape[0], run):
        dsums = _slab_diagonals(a_s[j0:j0 + run], b_s[j0:j0 + run],
                                beta=beta, n_slices=n_slices, full=full,
                                slice_dtype=sdt, acc_dtype=adt)
        for j in range(dsums[0].shape[0]):
            for dsum in dsums:
                acc = _fold_diagonal_sum(acc, dsum[j])
    return apply_epilogue(acc, alpha, beta_s, c, ops=mp.tier_module(a))


def _pair(slice_dtype_name, acc_dtype_name):
    """The variant of a (slice, accumulator) pair; ValueError naming a pair
    the kernel does not take."""
    try:
        return SLICE_PAIRS[slice_dtype_name, acc_dtype_name]
    except KeyError:
        raise ValueError(
            f"slices {slice_dtype_name} with accumulator {acc_dtype_name}: "
            f"the fused Ozaki kernel takes (slice, accumulator) pairs "
            f"{sorted(SLICE_PAIRS)}") from None


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


def _launch(nl, a, b, alpha, beta_s, c, batch, *, bk, beta, n_slices,
            n_diag, epi, variant=None):
    m, k = a[0].shape[-2:]
    n = b[0].shape[-1]
    dev = a[0].device
    lead = (batch,) if batch is not None else ()
    out = [torch.empty(lead + (m, n), dtype=torch.float64, device=dev)
           for _ in range(nl)]
    if m == 0 or n == 0 or batch == 0:
        return out
    # the drain reads each scalar's limbs from one buffer
    sc_alpha = torch.cat([l.reshape(1) for l in alpha]) if alpha else None
    sc_beta = torch.cat([l.reshape(1) for l in beta_s]) if beta_s else None

    def stride(ls, per):
        return per if ls and ls[0].dim() == 3 else 0

    narrow = variant is not None
    fn = _build.load("ozgemm_narrow", nl, variant).ozgemm_narrow if narrow \
        else _build.load("ozgemm", nl).ozgemm
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
        [ctypes.c_longlong] * 3 + [ctypes.c_int] * (6 if narrow else 5) + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_build.pointers(a), _build.pointers(b),
             None if sc_alpha is None else sc_alpha.data_ptr(),
             None if sc_beta is None else sc_beta.data_ptr(),
             _build.pointers(c or [None] * nl), _build.pointers(out),
             m, n, k, batch or 1, stride(a, m * k), stride(b, k * n),
             stride(c, m * n), bk, beta, n_slices, n_diag,
             EPILOGUES.index(epi), *((variant,) if narrow else ()),
             _build.stream(dev))
    if err:
        raise RuntimeError(
            f"ozgemm launch at {nl} limbs (variant {variant}) failed: CUDA "
            f"error {err} (bk={bk}, n_slices={n_slices})")
    launches[nl if variant is None else (nl, VARIANTS[variant])] += 1
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
    the plan's solved values.  ``slice_dtype_name`` / ``acc_dtype_name``:
    one of the pairs of ``SLICE_PAIRS`` -- f64/f64, bf16/f32, f32/f32,
    bf16/f64, f32/f64 -- any other raises ``ValueError`` naming it.  Any
    shape: ragged edges are the kernel's own business.  A slice count whose
    shared memory exceeds what a Hopper block may hold raises
    ``ValueError`` with the byte count.  Returns the nlimbs output limbs.
    """
    variant = _pair(slice_dtype_name, acc_dtype_name)
    nl, a, b, alpha, beta_s, c = _split_operands(operands, epilogue)
    dev, batch = _check(operands, a, b, alpha, beta_s, c)
    if bk < 1 or n_slices < 1:
        raise ValueError(f"bk={bk}, n_slices={n_slices} out of range")
    smem = smem_bytes(bk, n_slices, slice_dtype_name, acc_dtype_name)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"bk={bk} x n_slices={n_slices} with {slice_dtype_name} slices "
            f"asks {smem} B of shared memory per block; Hopper allows "
            f"{SMEM_LIMIT}")
    if dev.type == "cuda":
        n_diag = 2 * n_slices - 1 if full else n_slices
        return _launch(nl, a, b, alpha, beta_s, c, batch, bk=bk, beta=beta,
                       n_slices=n_slices, n_diag=n_diag, epi=epilogue,
                       variant=variant)

    def val(ls):
        return None if ls is None else mp.from_limbs(ls)

    out = ozgemm_plain(val(a), val(b), bk=bk, beta=beta, n_slices=n_slices,
                       full=full, alpha=val(alpha), beta_s=val(beta_s),
                       c=val(c), slice_dtype_name=slice_dtype_name,
                       acc_dtype_name=acc_dtype_name)
    return mp.limbs(out)
