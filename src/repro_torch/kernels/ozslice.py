"""Kernel #2's slicing pre-pass: each operand element's slices, once per call.

The slicing half of ``repro.kernels.ozgemm._slab_update``
(``core.ozaki._extract_slices``, and with narrow slices
``_normalize_slices``), moved out of the GEMM so that a row of A (a column
of B) is sliced once, not once per output tile.  Per K slab of the plan's
depth ``bk`` and per row of A (column of B): the anchor from the max of
``|limb 0|``, the ``n_slices`` error-free slices with the residual in its
own tier, and with narrow slices the scale ``sc = pow2_near(max |slice
0|)`` and each slice ``i`` stored as ``s * 2^(i*beta) / sc`` in the slice
type.

The workspace, per batch entry and slab (``csrc/ozslice.cu``'s layout):
slices ``(entries, nslab, n_slices, rows_padded(R), kdepth(bk))`` and, for
narrow slices, scales ``(entries, nslab, rows_padded(R))``, R being m for
A and n for B; rows beyond R and depth beyond the slab are zero slices (a
zero entry slices to zero and moves no maximum: the reference's padding).
An operand without a batch axis is one entry, which a batched GEMM shares.

On a CUDA tensor ``ozslice_call`` launches ``csrc/ozslice.cu`` (one
library per limb count, every slice type); on a CPU tensor it runs
``ozslice_plain``, the same arithmetic as tensor ops.  The two agree bit
for bit on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import mp
from ..core.ozaki import _extract_slices, _normalize_slices
from . import _build

__all__ = ["ozslice_call", "ozslice_plain", "launches", "STORAGE",
           "CUDA_VARIANT", "kdepth", "rows_padded", "workspace_shapes"]

# the slice variant (kernels.ozgemm.SLICE_PAIRS; None: f64 slices) -> the
# type the workspace stores its slices in (f16 holds the <= 11-bit slices
# of f32/f32 exactly)
STORAGE = {None: torch.float64, 0: torch.bfloat16, 1: torch.float16,
           2: torch.bfloat16, 3: torch.float32, 4: torch.float16}
# the normalized slices' type before storage (the reference's slice dtype)
_SLICE = {0: torch.bfloat16, 1: torch.float32, 2: torch.bfloat16,
          3: torch.float32, 4: torch.float16}
# the variant the CUDA sources build for a slice variant: f16/f32 (4) is
# f32/f32's code, whose workspace already holds its slices as f16 (a slice
# of either is exact in f16, so both store the same bits)
CUDA_VARIANT = {None: -1, 0: 0, 1: 1, 2: 2, 3: 3, 4: 1}
_TILE = 64  # rows of A (columns of B) per GEMM CTA

# launches of csrc/ozslice.cu in this process, per limb count (never of
# the plain version)
launches = dict.fromkeys(_build.LIMBS, 0)


def kdepth(bk, variant):
    """The workspace's slab depth: bk rounded up to the MMA depth (4 for the
    f64 m8n8k4, 16 for the bf16 m16n8k16; ``oz::kdepth``)."""
    q = 4 if variant is None else 16
    return -(-bk // q) * q


def rows_padded(r):
    """Rows (of A) or columns (of B) in the workspace: whole 64-row tiles."""
    return -(-r // _TILE) * _TILE


def workspace_shapes(entries, nslab, n_slices, rows, bk, variant):
    """(slices shape, scales shape or None) of one operand's workspace."""
    rp = rows_padded(rows)
    return ((entries, nslab, n_slices, rp, kdepth(bk, variant)),
            None if variant is None else (entries, nslab, rp))


def _geometry(lead, rows):
    """(entries, R, k) of an operand's leading limb: A (.., m, k) when
    ``rows``, else B (.., k, n)."""
    entries = lead.shape[0] if lead.dim() == 3 else 1
    r, k = lead.shape[-2:] if rows else lead.shape[-2:][::-1]
    return entries, r, k


def ozslice_plain(x, *, rows, bk, beta, n_slices, variant=None, slab0=0,
                  nslab=None):
    """The pre-pass's arithmetic as tensor ops, through the value's tier
    module (no kernel launch on any device).  ``x``: a tier value, A (m, k)
    when ``rows`` else B (k, n), with at most one leading batch axis;
    slabs ``slab0 .. slab0 + nslab - 1`` (all from slab0 when None).
    Returns (slices, scales or None) in the workspace's layout."""
    tier = mp.tier_module(x)
    entries, r, k = _geometry(mp.limbs(x)[0], rows)
    nslab = -(-k // bk) - slab0 if nslab is None else nslab
    rp = rows_padded(r)

    def cut(l):  # -> (entries, nslab, rp, bk), zero beyond the edges
        l = l.reshape((1,) * (3 - l.dim()) + tuple(l.shape))
        if not rows:
            l = l.transpose(-1, -2)
        l = l[..., slab0 * bk:(slab0 + nslab) * bk]
        l = torch.nn.functional.pad(
            l, (0, nslab * bk - l.shape[-1], 0, rp - r))
        return l.reshape(entries, rp, nslab, bk).transpose(1, 2)

    slices = _extract_slices(mp.map_limbs(cut, x), beta, n_slices, axis=-1,
                             ops=tier)
    scales = None
    if variant is not None:
        slices, scales = _normalize_slices(slices, beta, -1, _SLICE[variant])
        slices = [s.to(STORAGE[variant]) for s in slices]
        scales = scales[..., 0].contiguous()
    ws = torch.stack(slices, dim=2)
    ws = torch.nn.functional.pad(ws, (0, kdepth(bk, variant) - bk))
    return ws.contiguous(), scales


def _launch(limbs, rows, bk, beta, n_slices, variant, slab0, nslab, out):
    nl = len(limbs)
    lead = limbs[0]
    entries, r, k = _geometry(lead, rows)
    ws, scales = out
    fn = _build.load("ozslice", nl).ozslice
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + \
        [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ld_row, ld_k = (k, 1) if rows else (1, r)
    err = fn(_build.pointers(limbs), ws.data_ptr(),
             None if scales is None else scales.data_ptr(), r, k,
             slab0 * bk, nslab, entries, bk, ld_row, ld_k,
             lead.shape[-2] * lead.shape[-1] if lead.dim() == 3 else 0,
             beta, n_slices, CUDA_VARIANT[variant],
             _build.stream(lead.device))
    if err:
        raise RuntimeError(
            f"ozslice launch at {nl} limbs (variant {variant}) failed: CUDA "
            f"error {err} (bk={bk}, n_slices={n_slices}, nslab={nslab})")
    launches[nl] += 1
    return ws, scales


def ozslice_call(limbs, *, rows, bk, beta, n_slices, variant=None, slab0=0,
                 nslab=None, out=None):
    """The pre-pass on one operand's limbs (contiguous f64, (m, k) or (k,
    n), optionally with a leading batch axis): a launch of
    ``csrc/ozslice.cu`` on the card, ``ozslice_plain`` on the CPU.
    ``out``: workspace tensors to fill (reused across K panels), else new
    ones.  Returns (slices, scales or None)."""
    lead = limbs[0]
    entries, r, k = _geometry(lead, rows)
    nslab = -(-k // bk) - slab0 if nslab is None else nslab
    if lead.device.type != "cuda":
        return ozslice_plain(mp.from_limbs(list(limbs)), rows=rows, bk=bk,
                             beta=beta, n_slices=n_slices, variant=variant,
                             slab0=slab0, nslab=nslab)
    if out is None:
        shp, sshp = workspace_shapes(entries, nslab, n_slices, r, bk, variant)
        out = (torch.empty(shp, dtype=STORAGE[variant], device=lead.device),
               None if sshp is None else torch.empty(
                   sshp, dtype=torch.float64, device=lead.device))
    return _launch(limbs, rows, bk, beta, n_slices, variant, slab0, nslab,
                   out)
