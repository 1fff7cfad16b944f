"""Kernel #2: the fused Ozaki-slice GEMM (the ``ozaki-pallas`` backend).

The port of ``repro.kernels.ozgemm``, in two launches.  The pre-pass
(``kernels.ozslice``) slices each operand once per K slab of the plan's
depth ``bk`` on the slab's anchor ladders (``core.ozaki._extract_slices``;
with narrow slices normalized into the slice type per row of A and column
of B, ``core.ozaki._normalize_slices``) into a workspace.  The GEMM then,
per slab: sums each diagonal's pair dots exactly in the accumulator type;
rescales a narrow diagonal by ``(sc_a * sc_b) * 2^(-d*beta)``; folds each
diagonal into the k-limb accumulator (``dd.add_float`` at dd,
``renorm_list(acc + [dsum], k, sweeps=3)`` at td/qd).  The drain applies
the Rgemm epilogue (``none`` | ``alpha`` | ``full``, with the beta == 0
select) at k limbs.

The workspaces hold ``n_slices`` slices per operand element (f64: 8
bytes each; narrow: 2, or 4 for f32/f64).  Where both operands' together
would pass ``WORKSPACE_BYTES`` (2 GiB), K is walked in panels of whole
slabs: pre-pass and GEMM per panel, the accumulator carried in the output
between GEMM launches, the epilogue on the last panel only.  Slabs fold
in slab order either way, so the bits do not change.

On a CUDA tensor the wrapper launches hand-written Hopper kernels at 2, 3
or 4 limbs: ``csrc/ozslice.cu``, then ``csrc/ozgemm.cu`` for f64 slices
(pair dots on the f64 tensor cores) or ``csrc/ozgemm_narrow.cu`` for
narrow ones (bf16 and f16 pair dots on the 16-bit tensor cores, f32
slices with an f64 accumulator on the f64 ones); see those files for
their design and bound.  A failed launch raises; nothing falls back.  On
a CPU tensor it runs ``ozgemm_plain``, the same algorithm as tensor ops on
the plain pre-pass's workspace.  The two agree bit for bit on the card.

The (slice, accumulator) pairs are the ones the reference's kernel takes
from a plan (``SLICE_PAIRS``): f64/f64, bf16/f32, f32/f32, f16/f32, and
bf16 or f32 slices with an f64 accumulator (what
``make_plan(slice_dtype=...)`` alone gives: the plan keeps
``acc_dtype=None`` and the engine reads f64).  Any other pair raises
``ValueError``, on both devices; the reference's planner also makes two
the kernel refuses: f16/f64, whose beta reaches 22 so that the
reference's f16 slices are rounded, and f64/f32, an f64 slice dot typed
to f32.

A, B and C may carry one leading batch axis (an operand without it is
shared); on the card the batch is the kernel's third grid axis.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from .._device import common_device
from ..core import mp
from ..core.ozaki import _fold_diagonal_sum, as_dtype, diagonal_sums
from . import _build
from .ozslice import (CUDA_VARIANT, STORAGE, kdepth, ozslice_call,
                      ozslice_plain, rows_padded)

__all__ = ["ozgemm_kernel_call", "ozgemm_plain", "EPILOGUES", "launches",
           "SLICE_PAIRS", "VARIANTS", "SMEM_LIMIT", "smem_bytes",
           "WORKSPACE_BYTES", "panel_slabs", "launch_shapes", "f32_group"]

EPILOGUES = ("none", "alpha", "full")

# (slice dtype, accumulator dtype) -> the narrow variant's number
# (csrc/ozgemm_narrow.cu, whose build ozslice.CUDA_VARIANT names), None for
# the f64-slice kernel (csrc/ozgemm.cu)
SLICE_PAIRS = {
    ("float64", "float64"): None,  # DMMA (mma.sync m16n8k4)
    ("bfloat16", "float32"): 0,    # bf16 mma.sync m16n8k16, f32 sums
    ("float32", "float32"): 1,     # f16 mma.sync m16n8k16 (f16-held slices)
    ("bfloat16", "float64"): 2,    # bf16 m16n8k16, f32 groups into f64 sums
    ("float32", "float64"): 3,     # DMMA on the slices widened to f64
    ("float16", "float32"): 4,     # variant 1's code and library
}
_SHORT = {"float64": "f64", "float32": "f32", "bfloat16": "bf16",
          "float16": "f16"}
VARIANTS = {v: f"{_SHORT[s]}/{_SHORT[a]}"
            for (s, a), v in SLICE_PAIRS.items() if v is not None}

# launches of the CUDA kernels in this process (never of the plain
# version): per limb count for f64 slices, and per (limb count,
# "slice/acc") for each narrow variant, e.g. launches[2, "bf16/f32"]
launches = dict.fromkeys(_build.LIMBS, 0)
launches.update({(nl, name): 0 for nl in _build.LIMBS
                 for name in VARIANTS.values()})
# the same launches by (key of ``launches``, (batch, m, k, n))
launch_shapes = collections.Counter()

# shared memory one Hopper block may opt in to, and the batch grid limit
SMEM_LIMIT = 232448
MAX_BATCH = 65535
_TILE = 64 + 64  # rows of A plus columns of B per CTA
# both operands' workspaces together, per K panel (bytes)
WORKSPACE_BYTES = 2 << 30
# what the plain version holds of a run of K slabs' diagonals at once
_PLAIN_RUN_BYTES = 1 << 30


def smem_bytes(bk, n_slices, slice_dtype_name="float64",
               acc_dtype_name="float64"):
    """Shared memory one CTA of the GEMM asks for: ``oz::smem_bytes`` of
    ``csrc/oz_device.cuh``, the count both GEMM builds launch with,
    repeated here so that CPU tensors are refused alike (chip_smoke.py
    holds the two equal on the card).  One stage holds a slab's slices of
    the CTA's 64 rows and 64 columns (rows padded by 32 bytes for f64, 8
    elements for narrow slices) and the narrow scales; every variant runs
    two stages where two fit, else one."""
    variant = SLICE_PAIRS[slice_dtype_name, acc_dtype_name]
    ks = kdepth(bk, variant) + (4 if variant is None else 8)
    stage = n_slices * _TILE * ks * STORAGE[variant].itemsize
    if variant is not None:
        stage += _TILE * 8
    return (2 if 2 * stage <= SMEM_LIMIT else 1) * stage


def f32_group(beta):
    """bf16/f64: the MMA results (zero-C 16-deep dots of one slice pair)
    that ``csrc/ozgemm_narrow.cu`` sums in one f32 group before it adds the
    group into the diagonal's f64 sum: the largest G with ``G * 16 *
    2^(2*beta) <= 2^24``, so that every partial sum of a group is exact in
    f32 (each result is at most 16 products below 2^(2*beta) grid units).
    At slab depth bk a pair dot is ``kdepth(bk) / 16`` results, so a group
    holds ``G // (kdepth(bk) / 16)`` pairs: 16, 8, 4 at bk 16, 32, 64 and
    beta 8, the largest pair counts with ``2*beta + ceil(log2 bk) +
    ceil(log2 pairs) <= 24``."""
    log2_g = 24 - 4 - 2 * beta
    if log2_g < 1:  # the kernel adds two pairs' results at a time
        raise ValueError(f"beta={beta}: an f32 group of bf16 MMA results "
                         f"holds fewer than two")
    return 2 ** log2_g


def panel_slabs(nslab, entries_a, m, entries_b, n, bk, n_slices, variant,
                budget=None):
    """K slabs per panel: as many as both operands' workspaces hold within
    ``budget`` bytes (``WORKSPACE_BYTES``), at least one."""
    budget = WORKSPACE_BYTES if budget is None else budget
    rows = entries_a * rows_padded(m) + entries_b * rows_padded(n)
    per_slab = rows * (n_slices * kdepth(bk, variant)
                       * STORAGE[variant].itemsize
                       + (0 if variant is None else 8))
    return max(1, min(nslab, budget // max(per_slab, 1)))


def _fold_panel(acc, wa, sca, wb, scb, *, m, n, beta, n_slices, full,
                acc_dtype, batched):
    """Fold one K panel's slabs into acc from the workspaces, in slab order:
    each diagonal's pair dots summed in ``acc_dtype`` (a run of slabs at
    once), a narrow diagonal rescaled by ``(sc_a * sc_b) * 2^(-d*beta)``
    (``repro.kernels.ozgemm._slab_update`` step for step)."""
    nslab = wa.shape[1]
    n_diag = 2 * n_slices - 1 if full else n_slices
    entries = max(wa.shape[0], wb.shape[0])
    run = max(1, _PLAIN_RUN_BYTES // (8 * entries * n_diag * m * n or 1))
    for j0 in range(0, nslab, run):
        js = slice(j0, j0 + run)
        # (run, entries, m, kp) and (run, entries, kp, n)
        sa = [wa[:, js, s, :m].transpose(0, 1) for s in range(n_slices)]
        sb = [wb[:, js, t, :n].transpose(0, 1).transpose(-1, -2)
              for t in range(n_slices)]
        dsums = list(diagonal_sums(sa, sb, n_slices, full, acc_dtype))
        if sca is not None:
            sab = sca[:, js, :m].transpose(0, 1)[..., None] \
                * scb[:, js, :n].transpose(0, 1)[..., None, :]
            dsums = [(d, ds.to(torch.float64) * (sab * 2.0 ** (-d * beta)))
                     for d, ds in dsums]
        for j in range(dsums[0][1].shape[0]):
            for _, ds in dsums:
                acc = _fold_diagonal_sum(acc, ds[j] if batched else ds[j, 0])
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
                 beta_s=None, c=None, slice_dtype_name="float64",
                 acc_dtype_name="float64", workspace_bytes=None):
    """The kernels' algorithm as tensor ops (tier values in, tier value
    out; A and B may carry one leading batch axis, an operand without it
    being shared): the plain pre-pass's workspaces, K panel by K panel as
    the kernels walk them, and the tier module's arithmetic; no kernel
    launch on any device."""
    variant = _pair(slice_dtype_name, acc_dtype_name)
    adt = as_dtype(acc_dtype_name)
    la, lb = mp.limbs(a)[0], mp.limbs(b)[0]
    m, k = la.shape[-2:]
    n = lb.shape[-1]
    batch = tuple(np.broadcast_shapes(la.shape[:-2], lb.shape[:-2]))
    acc = mp.zeros(batch + (m, n), mp.precision_of(a), dtype=la.dtype,
                   device=la.device)
    nslab = -(-k // bk)
    panel = panel_slabs(nslab, la.shape[0] if la.dim() == 3 else 1, m,
                        lb.shape[0] if lb.dim() == 3 else 1, n, bk, n_slices,
                        variant, workspace_bytes)
    kw = dict(bk=bk, beta=beta, n_slices=n_slices, variant=variant)
    for p0 in range(0, nslab, panel):
        cnt = min(panel, nslab - p0)
        wa, sca = ozslice_plain(a, rows=True, slab0=p0, nslab=cnt, **kw)
        wb, scb = ozslice_plain(b, rows=False, slab0=p0, nslab=cnt, **kw)
        acc = _fold_panel(acc, wa, sca, wb, scb, m=m, n=n, beta=beta,
                          n_slices=n_slices, full=full, acc_dtype=adt,
                          batched=bool(batch))
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
            n_diag, epi, variant=None, workspace_bytes=None, workspaces=None):
    """The pre-pass and the GEMM, K panel by K panel.  ``workspaces``: the
    pre-pass's (A, B) output for the whole of K, to launch the GEMM alone
    (chip_smoke.py times the two apart)."""
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
    ea = batch if a[0].dim() == 3 else 1
    eb = batch if b[0].dim() == 3 else 1
    nslab = -(-k // bk)
    panel = nslab if workspaces else panel_slabs(
        nslab, ea, m, eb, n, bk, n_slices, variant, workspace_bytes)
    kp = kdepth(bk, variant)

    narrow = variant is not None
    cv = CUDA_VARIANT[variant]
    fn = _build.load("ozgemm_narrow", nl, cv).ozgemm_narrow if narrow \
        else _build.load("ozgemm", nl).ozgemm
    fn.argtypes = [ctypes.c_void_p] * (8 if narrow else 6) + \
        [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3 + \
        [ctypes.c_int] * (8 if narrow else 5) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    pkw = dict(bk=bk, beta=beta, n_slices=n_slices, variant=variant)

    def ptr(t):
        return None if t is None else t.data_ptr()

    ws_a, ws_b = workspaces or (None, None)
    # K == 0 is one launch over no slab: the drain of a zero accumulator
    for p0 in range(0, max(nslab, 1), panel):
        cnt = min(panel, nslab - p0)
        if cnt > 0 and not workspaces:  # the buffers serve every panel
            ws_a = ozslice_call(a, rows=True, slab0=p0, nslab=cnt, out=ws_a,
                                **pkw)
            ws_b = ozslice_call(b, rows=False, slab0=p0, nslab=cnt,
                                out=ws_b, **pkw)
        (wa, sca), (wb, scb) = ws_a or (None, None), ws_b or (None, None)
        flags = (1 if p0 > 0 else 0) | (2 if p0 + panel >= nslab else 0)

        def ws_stride(e, rows):
            return cnt * n_slices * rows_padded(rows) * kp if e > 1 else 0

        args = [ptr(wa), ptr(sca), ptr(wb), ptr(scb)] if narrow \
            else [ptr(wa), ptr(wb)]
        args += [ptr(sc_alpha), ptr(sc_beta),
                 _build.pointers(c or [None] * nl), _build.pointers(out),
                 m, n]
        args += [cnt, batch or 1, ws_stride(ea, m), ws_stride(eb, n),
                 m * n if c and c[0].dim() == 3 else 0, bk]
        args += [beta, n_slices] if narrow else [n_slices]
        args += [n_diag, EPILOGUES.index(epi), flags]
        args += [cv, f32_group(beta) if cv == 2 else 0] if narrow else []
        err = fn(*args, _build.stream(dev))
        if err:
            raise RuntimeError(
                f"ozgemm launch at {nl} limbs (variant {variant}) failed: "
                f"CUDA error {err} (bk={bk}, n_slices={n_slices}, panel "
                f"{p0}+{cnt} of {nslab} slabs)")
        key = nl if variant is None else (nl, VARIANTS[variant])
        launches[key] += 1
        launch_shapes[key, (batch or 1, m, k, n)] += 1
    return out


def ozgemm_kernel_call(*operands, bk: int, beta: int, n_slices: int,
                       slice_dtype_name: str = "float64",
                       acc_dtype_name: str = "float64",
                       epilogue: str = "none", full: bool = False,
                       workspace_bytes: int | None = None):
    """Raw kernel invocation: the pre-pass and the GEMM.

    ``operands``: nlimbs A limbs (m, k) + nlimbs B limbs (k, n), nlimbs =
    2, 3 or 4; with ``epilogue="alpha"`` also nlimbs (1, 1) alpha limbs;
    with ``"full"`` additionally nlimbs (1, 1) beta limbs and nlimbs (m, n)
    C limbs.  A, B and C limbs may carry a leading batch axis (nb, ...);
    without it an operand is shared.  ``bk``, ``beta`` and ``n_slices`` are
    the plan's solved values.  ``slice_dtype_name`` / ``acc_dtype_name``:
    one of the pairs of ``SLICE_PAIRS`` -- f64/f64, bf16/f32, f32/f32,
    f16/f32, bf16/f64, f32/f64 -- any other raises ``ValueError`` naming
    it.  Any shape: ragged edges are the kernel's own business.  A slice
    count whose shared memory exceeds what a Hopper block may hold raises
    ``ValueError`` with the byte count.  ``workspace_bytes``: the K-panel
    budget of both operands' workspaces (``WORKSPACE_BYTES`` when None).
    Returns the nlimbs output limbs.
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
                       variant=variant, workspace_bytes=workspace_bytes)

    def val(ls):
        return None if ls is None else mp.from_limbs(ls)

    out = ozgemm_plain(val(a), val(b), bk=bk, beta=beta, n_slices=n_slices,
                       full=full, alpha=val(alpha), beta_s=val(beta_s),
                       c=val(c), slice_dtype_name=slice_dtype_name,
                       acc_dtype_name=acc_dtype_name,
                       workspace_bytes=workspace_bytes)
    return mp.limbs(out)
