"""Execution engine: one dispatcher for every extended-precision GEMM.

The port of the single-device 2-D path of ``repro.gemm.engine``:
``execute(plan, a, b)`` routes a planned workload to its backend and
carries the Rgemm alpha/beta epilogue.  On the ``ozaki-pallas`` path the
epilogue is fused into kernel #2's drain; every other path applies the
identical tier arithmetic as a post-step (the same function the kernel's
plain version drains with), so results match cell for cell.

The reference pads operands to block multiples for its Pallas grids; the
CUDA kernels mask ragged edges themselves (zero padding is a bitwise no-op
on a normalized accumulator, so the two agree), and the engine only makes
operands contiguous.

Batched execution mirrors the reference's ``_execute_batched``: leading
batch dims broadcast and flatten to one batch axis, an operand without
batch dims is shared (not copied), and the output takes the batch shape
back.  Where the reference vmaps the planned 2-D kernel, each backend here
takes the batch axis itself: the two CUDA kernels as a grid axis (one
launch per call), the tensor-op backends by broadcasting.  As in the
reference, a batched call applies the epilogue as a post-step on every
backend.  Sharded, streamed and guarded execution and failover are not
ported yet (``make_plan`` raises on their options).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .._device import common_device
from ..core import mp
from ..kernels.ozgemm import apply_epilogue as _apply_epilogue
from .plan import OZAKI_TARGET_BITS, GemmPlan, _clamp_blocks, make_plan

__all__ = ["execute", "matmul"]


def _contiguous(x):
    return mp.map_limbs(lambda l: l.contiguous(), x)


def _execute_pallas(plan: GemmPlan, a, b):
    """Kernel #1 (``csrc/mlgemm.cu`` on CUDA, its plain version on CPU)."""
    from ..kernels.mlgemm import mlgemm_kernel_call

    out = mlgemm_kernel_call(*mp.limbs(_contiguous(a)),
                             *mp.limbs(_contiguous(b)))
    return mp.from_limbs(out)


def _ozaki_pallas_params(plan: GemmPlan, bk: int):
    """(beta, n_slices, slice_dtype_name, acc_dtype_name) for a slab depth.

    The plan solved (beta, n_slices) for its own bk; a re-clamped smaller
    slab only gains headroom.  Hand-built plans get them solved here.
    """
    from ..core import ozaki as _ozaki

    sdt = plan.slice_dtype or "float64"
    adt = plan.acc_dtype or "float64"
    beta, n_slices = plan.slice_beta, plan.n_slices
    if beta is None or n_slices is None:
        beta, n_slices = _ozaki.slice_params(
            bk, adt, sdt,
            target_bits=plan.target_bits or OZAKI_TARGET_BITS[plan.precision],
            n_slices=n_slices, beta=beta)
    return beta, n_slices, sdt, adt


def _execute_ozaki_pallas(plan: GemmPlan, a, b, alpha=None, beta=None,
                          c=None):
    """Kernel #2, optionally with the in-drain epilogue."""
    from ..kernels.ozgemm import ozgemm_kernel_call

    m, k = a.shape[-2:]
    n = b.shape[-1]
    bk = _clamp_blocks(m, k, n, plan.blocks)["bk"]
    sbeta, n_slices, sdt, adt = _ozaki_pallas_params(plan, bk)
    operands = [*mp.limbs(_contiguous(a)), *mp.limbs(_contiguous(b))]
    epilogue = "none"
    if alpha is not None:
        epilogue = "alpha" if c is None else "full"
        operands += [l.reshape(1, 1) for l in mp.limbs(alpha)]
        if c is not None:
            operands += [l.reshape(1, 1) for l in mp.limbs(beta)]
            operands += list(mp.limbs(_contiguous(c)))
    out = ozgemm_kernel_call(*operands, bk=bk, beta=sbeta,
                             n_slices=n_slices, slice_dtype_name=sdt,
                             acc_dtype_name=adt, epilogue=epilogue,
                             full=bool(plan.full))
    return mp.from_limbs(out)


def _execute_2d(plan: GemmPlan, a, b):
    if plan.backend == "ozaki-pallas":
        return _execute_ozaki_pallas(plan, a, b)
    if plan.backend == "pallas":
        return _execute_pallas(plan, a, b)
    if plan.backend == "ozaki":
        if plan.precision == "qd":
            raise ValueError("ozaki backend has no qd tier (make_plan "
                             "should have rerouted or rejected this plan)")
        from ..core.ozaki import ozaki_gemm

        kw = {}
        if plan.slice_dtype:
            kw["slice_dtype"] = plan.slice_dtype
        if plan.acc_dtype:
            kw["acc_dtype"] = plan.acc_dtype
        if plan.n_slices is not None:
            kw["n_slices"] = plan.n_slices
        if plan.slice_beta is not None:
            kw["beta"] = plan.slice_beta
        kw["target_bits"] = plan.target_bits or \
            OZAKI_TARGET_BITS[plan.precision]
        if plan.full is not None:
            kw["full"] = plan.full
        return ozaki_gemm(a, b, **kw)
    if plan.backend == "xla":
        from ..kernels.ops import matmul_ml_xla

        return matmul_ml_xla(a, b, chunk=plan.bk)
    if plan.backend == "ref":
        from ..kernels.ref import mlgemm_ref

        return mlgemm_ref(a, b)
    raise ValueError(f"unknown backend in plan: {plan.backend!r}")


def _execute_batched(plan: GemmPlan, a, b):
    """The planned backend over leading batch dims (the reference vmaps
    ``_execute_2d``; here every backend takes one batch axis)."""
    a_batch, b_batch = tuple(a.shape[:-2]), tuple(b.shape[:-2])
    batch = tuple(np.broadcast_shapes(a_batch, b_batch))
    nb = math.prod(batch)

    def flat(x, had_batch):
        if not had_batch:
            return x  # shared by every batch entry
        tgt = batch + tuple(x.shape[-2:])
        return mp.map_limbs(
            lambda l: torch.broadcast_to(l, tgt).reshape(
                (nb,) + tuple(l.shape[-2:])), x)

    out = _execute_2d(plan, flat(a, bool(a_batch)), flat(b, bool(b_batch)))
    m, n = out.shape[-2:]
    return mp.map_limbs(lambda l: l.reshape(batch + (m, n)), out)


def _as_scalar(x, precision: str, like: torch.Tensor):
    """Coerce a python float / tier scalar to the operands' tier."""
    try:
        return mp.promote(x, precision)
    except TypeError:
        return mp.from_float(torch.as_tensor(x, dtype=like.dtype,
                                             device=like.device), precision)


def _static_zero(x) -> bool:
    """True iff ``x`` is zero (python number, tensor or tier value)."""
    if x is None:
        return False
    if isinstance(x, (int, float)):
        return x == 0
    try:
        ls = mp.limbs(x)
    except TypeError:
        ls = [torch.as_tensor(x)]
    return all(not bool(torch.any(l != 0)) for l in ls)


def execute(plan: GemmPlan, a, b, *, alpha=None, beta=None, c=None):
    """Run C = alpha * (A @ B) + beta * C under a plan.

    A: (..., m, k), B: (..., k, n); batch dims need a plan made with
    ``batch_shape=`` (``matmul`` does this).  BLAS semantics as in the
    reference: with ``c`` alone, alpha = beta = 1 (C is added, never
    dropped); ``beta == 0`` means C is **not read** (NaN/Inf in C cannot
    leak); a nonzero beta without ``c`` raises ``ValueError``.  Operands
    must share one device.
    """
    prec = mp.precision_of(a)
    if mp.precision_of(b) != prec:
        raise TypeError(f"operand tiers differ: {mp.precision_of(a)} vs "
                        f"{mp.precision_of(b)}")
    if prec != plan.precision:
        raise ValueError(
            f"plan is for precision={plan.precision!r} but operands are "
            f"{prec!r}; rebuild with make_plan(..., precision={prec!r})")
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"inner dims mismatch: {a.shape} x {b.shape}")
    lead = mp.limbs(a)[0]
    if beta is not None and c is None:
        if not _static_zero(beta):
            raise ValueError(
                f"beta={beta!r} was passed without c=; beta scales C, so a "
                f"nonzero beta without a C operand would be silently "
                f"dropped — pass c=, or beta=0 (BLAS: C not read)")
        beta = None
    if c is not None and _static_zero(beta):
        c = beta = None  # BLAS: beta == 0 means C is NOT read
    if c is not None and alpha is None:
        alpha = 1.0
    if alpha is not None:
        alpha = _as_scalar(alpha, prec, lead)
    if c is not None:
        beta = _as_scalar(1.0 if beta is None else beta, prec, lead)
        if mp.precision_of(c) != prec:
            raise TypeError(f"C tier {mp.precision_of(c)} != operand "
                            f"tier {prec}")
    common_device(*mp.limbs(a), *mp.limbs(b),
                  *(mp.limbs(alpha) if alpha is not None else ()),
                  *(mp.limbs(beta) if beta is not None else ()),
                  *(mp.limbs(c) if c is not None else ()))
    if len(a.shape) > 2 or len(b.shape) > 2:
        if plan.batch == "none":
            raise ValueError(
                "plan was made for 2-D operands but inputs have batch dims; "
                "rebuild with batch_shape= (engine.matmul does this)")
        return _apply_epilogue(_execute_batched(plan, a, b), alpha, beta, c)
    if alpha is not None and plan.backend == "ozaki-pallas":
        # fused drain: the epilogue runs before the C' tile leaves the CTA
        return _execute_ozaki_pallas(plan, a, b, alpha=alpha, beta=beta,
                                     c=c)
    return _apply_epilogue(_execute_2d(plan, a, b), alpha, beta, c)


def matmul(a, b, *, plan: Optional[GemmPlan] = None, alpha=None, beta=None,
           c=None, **overrides):
    """Plan-and-execute convenience: the repo-wide GEMM entry point.

    The tier is inferred from the operand type and the platform from the
    operands' device; ``overrides`` feed ``make_plan``.  ``plan=`` and
    overrides are exclusive.
    """
    if plan is not None and overrides:
        raise ValueError(
            f"pass either plan= or planner overrides, not both (got "
            f"overrides {sorted(overrides)} with an explicit plan; use "
            f"plan.with_(...) to modify it)")
    if plan is None:
        m, k = a.shape[-2:]
        k2, n = b.shape[-2:]
        if k != k2:
            raise ValueError(f"inner dims mismatch: {a.shape} x {b.shape}")
        lead = mp.limbs(a)[0]
        overrides.setdefault("precision", mp.precision_of(a))
        overrides.setdefault("platform", lead.device.type)
        overrides.setdefault("batch_shape", tuple(np.broadcast_shapes(
            a.shape[:-2], b.shape[:-2])))
        plan = make_plan(m, k, n, dtype=lead.dtype, **overrides)
    return execute(plan, a, b, alpha=alpha, beta=beta, c=c)
