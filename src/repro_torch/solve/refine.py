"""Tiered iterative-refinement linear solvers (the paper's application layer).

The port of ``repro.solve.refine``:

    factor   P A = L U            at  u_factor   (f64, dd, td, or qd)
    repeat   r = b - A x          at  u_target   (one engine ``execute``)
             d = U \\ (L \\ P r)    at  u_factor
             x = x + d            at  u_target

converging at rate ~ cond(A) * u_factor per step while cond(A) <
1/u_factor; when the per-column backward error stagnates the solver
escalates the factorization one rung up the ladder (default f64 -> dd ->
td -> qd, ``ladder=`` overrides it).  The residual is one engine call
with the fused alpha/beta epilogue, so ``plan=`` / ``**plan_overrides``
(``backend="pallas"`` puts it on kernel #1, ``"ozaki-pallas"`` on kernel
#2) reach the GEMM as in the reference.  Right-hand sides may carry
leading batch dims (..., n, nrhs): the residual is one batched engine call
and the corrections solve every column at once, as in the reference.

The f64 rung: on CPU tensors it runs the LAPACK the reference runs (on
the CPU jaxlib binds SciPy's): ``scipy.linalg.lu_factor`` and
``cholesky`` (of the symmetrized input, as ``jnp.linalg.cholesky``
symmetrizes), and BLAS ``dtrsm`` for the solves, which reproduce the
reference's factors and solutions bit for bit.  On CUDA tensors it runs
``torch.linalg`` on the card.  A Cholesky that breaks down returns NaN, as
JAX's does, so the ladder escalates instead of raising.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..core import mp
from ..core.blas import rlange
from ..core.linalg import cholesky_solve, lu_solve, rgetrf, rpotrf
from ..gemm import execute, make_plan

__all__ = ["TIERS", "LADDER_CELLS", "RefinementInfo", "rgesv", "rposv",
           "lu_solve_refined", "cholesky_solve_refined", "tier_eps"]

# the default escalation ladder, cheapest first
TIERS = ("f64", "dd", "td", "qd")

# every meaningful (factor_tier, target_tier) pair
LADDER_CELLS = tuple(
    (f, t) for t in TIERS if t != "f64"
    for f in TIERS if TIERS.index(f) <= TIERS.index(t))

_TIER_ALIASES = {
    "f64": "f64", "double": "f64", "float64": "f64",
    "dd": "dd", "binary128": "dd", "dd64": "dd",
    "td": "td", "binary192": "td", "td64": "td",
    "qd": "qd", "binary128+": "qd", "qd64": "qd",
}


def _tier(name: str) -> str:
    try:
        return _TIER_ALIASES[name]
    except KeyError:
        raise ValueError(f"unknown tier {name!r}; one of "
                         f"{sorted(set(_TIER_ALIASES))}") from None


def _rank(tier: str) -> int:
    """Cost/precision rank of a rung: its limb count (f64 counts as one)."""
    return 1 if tier == "f64" else mp.PRECISIONS[tier]


def _resolve_ladder(ladder) -> tuple:
    """Canonicalize a ``ladder=`` override (None -> the default TIERS):
    known tiers in strictly-ascending precision order."""
    rungs = tuple(_tier(t) for t in (TIERS if ladder is None else ladder))
    if not rungs:
        raise ValueError("ladder must name at least one rung")
    ranks = [_rank(t) for t in rungs]
    if any(hi <= lo for lo, hi in zip(ranks, ranks[1:])):
        raise ValueError(f"ladder rungs must be strictly ascending, "
                         f"cheapest first; got {rungs}")
    return rungs


def tier_eps(tier: str) -> float:
    """Unit roundoff of a ladder rung (f64 included)."""
    t = _tier(tier)
    return 2.0 ** -53 if t == "f64" else mp.eps(t)


def _is_ml(x) -> bool:
    try:
        mp.precision_of(x)
        return True
    except TypeError:
        return False


def _as_tier(x, tier: str, device=None):
    """Coerce an f64 array / tensor / tier value to a ladder rung: climbing
    is exact, descending rounds to the cheaper tier."""
    t = _tier(tier)
    if _is_ml(x):
        return mp.to_float(x) if t == "f64" else mp.promote(x, t)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, np.float64),
                            device=resolve_device(device))
    x = x.to(torch.float64)
    return x if t == "f64" else mp.from_float(x, t)


def _factor_f64_cpu(a, assume: str):
    """The reference's CPU LAPACK calls: (lu, 0-based piv) or lower L."""
    import warnings

    import scipy.linalg as sl

    x = a.numpy()
    if assume == "pos":
        try:
            return torch.from_numpy(sl.cholesky((x + x.T) / 2, lower=True,
                                                check_finite=False))
        except np.linalg.LinAlgError:
            return torch.full_like(a, float("nan"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", sl.LinAlgWarning)
        lu, piv = sl.lu_factor(x, check_finite=False)
    return torch.from_numpy(lu), torch.from_numpy(piv.astype(np.int64))


def _solve_f64_cpu(fac, assume: str, rhs):
    """``jsl.lu_solve`` / two ``solve_triangular``s as BLAS dtrsm calls."""
    from scipy.linalg.blas import dtrsm

    b = rhs.numpy()
    if assume == "pos":
        lo = fac.numpy()
        y = dtrsm(1.0, lo, b, lower=1)
        return torch.from_numpy(dtrsm(1.0, lo, y, lower=1, trans_a=1))
    lu, piv = fac[0].numpy(), fac[1].tolist()
    perm = np.arange(len(piv))
    for i, p in enumerate(piv):
        perm[i], perm[p] = perm[p], perm[i]
    y = dtrsm(1.0, lu, b[perm], lower=1, diag=1)
    return torch.from_numpy(dtrsm(1.0, lu, y, lower=0))


def _factorize(a_target, tier: str, assume: str, block: int):
    """Factor A (held at the target tier) at a ladder rung."""
    a_f = _as_tier(a_target, tier)
    if tier == "f64":
        if a_f.device.type == "cpu":
            return _factor_f64_cpu(a_f, assume)
        if assume == "pos":
            low, info = torch.linalg.cholesky_ex(a_f)
            return low if int(info) == 0 else torch.full_like(
                a_f, float("nan"))
        return torch.linalg.lu_factor(a_f)
    if assume == "pos":
        return rpotrf(a_f)
    return rgetrf(a_f, block=block)


def _fsolve(fac, tier: str, assume: str, rhs):
    """Solve with a rung's factorization; rhs (n, ncols) and the result
    live at that rung (batched systems are flattened to columns by the
    caller: triangular substitution is column-independent)."""
    if tier == "f64":
        if rhs.device.type == "cpu":
            return _solve_f64_cpu(fac, assume, rhs)
        if assume == "pos":
            y = torch.linalg.solve_triangular(fac, rhs, upper=False)
            return torch.linalg.solve_triangular(fac.T, y, upper=True)
        return torch.linalg.lu_solve(fac[0], fac[1], rhs)
    if assume == "pos":
        return cholesky_solve(fac, rhs)
    lu, piv = fac
    return lu_solve(lu, piv, rhs)


def _cols(x, n: int):
    """(..., n, nrhs) -> (n, batch*nrhs) column view (and its inverse)."""
    return mp.map_limbs(lambda l: torch.movedim(l, -2, 0).reshape(n, -1), x)


def _uncols(x2d, like):
    shp = tuple(like.shape)
    return mp.map_limbs(
        lambda l: torch.movedim(
            l.reshape(shp[-2:-1] + shp[:-2] + shp[-1:]), 0, -2), x2d)


def _col_max(x):
    """Per-column max |entry| of a multi-limb value (leading limb decides)."""
    return torch.amax(torch.abs(mp.limbs(x)[0]), dim=-2)


@dataclasses.dataclass
class RefinementInfo:
    """Convergence report of one refinement-backed solve."""

    converged: bool
    iterations: int
    target_tier: str
    tol: float
    backward_errors: List[float]          # berr of the iterate per iteration
    factor_tiers: List[str]               # rung in effect at each iteration
    escalations: List[dict]               # {iteration, from, to, ratio}
    factorizations: dict                  # rung -> count performed
    stagnations: int = 0
    # backward error of the RETURNED x (the best measured iterate when a
    # diverged final step makes the solver fall back to it)
    final_backward_error: float = float("inf")
    # why a non-converged solve stopped: "escalation-capped",
    # "ladder-exhausted" or "iteration-budget" with context; empty on a
    # converged solve
    hazards: List[dict] = dataclasses.field(default_factory=list)


def _refine(a, b, *, factor_tier, target_tier, assume, factorization,
            max_iters, tol, stagnation_ratio, block, plan, plan_overrides,
            max_escalations=None, ladder=None, device=None):
    if max_escalations is not None and max_escalations < 0:
        raise ValueError(f"max_escalations must be >= 0 or None, "
                         f"got {max_escalations}")
    ladder = _resolve_ladder(ladder)
    factor_tier = ladder[0] if factor_tier is None else _tier(factor_tier)
    if target_tier is None:
        target_tier = mp.precision_of(a) if _is_ml(a) else "dd"
    target_tier = _tier(target_tier)
    if target_tier == "f64":
        raise ValueError("target_tier must be an extended tier (dd, td, or "
                         "qd); a plain f64 solve needs no refinement "
                         "subsystem")
    for name, t in (("factor_tier", factor_tier), ("target_tier",
                                                   target_tier)):
        if t not in ladder:
            raise ValueError(f"{name} {t!r} is not a rung of the ladder "
                             f"{ladder}")
    if ladder.index(factor_tier) > ladder.index(target_tier):
        raise ValueError(f"factor_tier {factor_tier!r} is above "
                         f"target_tier {target_tier!r} on the ladder")

    a_t = _as_tier(a, target_tier, device)
    lead = mp.limbs(a_t)[0]
    vector_rhs = (len(b.shape) if _is_ml(b) else np.ndim(b)) == 1
    b_t = _as_tier(b, target_tier, lead.device)
    if vector_rhs:
        b_t = mp.map_limbs(lambda l: l[:, None], b_t)
    n = a_t.shape[-1]
    nrhs = b_t.shape[-1]
    batch_shape = tuple(b_t.shape[:-2])

    if plan is not None and plan_overrides:
        raise ValueError("pass either plan= or planner overrides, not both")
    if plan is None:
        plan_overrides.setdefault("platform", lead.device.type)
        plan = make_plan(n, n, nrhs, dtype=lead.dtype,
                         precision=target_tier, batch_shape=batch_shape,
                         **plan_overrides)
    elif plan.precision != target_tier:
        plan = make_plan(n, n, nrhs, dtype=plan.limb_dtype,
                         precision=target_tier, backend=plan.backend,
                         platform=plan.platform,
                         batch_shape=plan.batch_shape)

    if tol is None:
        tol = 2.0 * n * tier_eps(target_tier)

    anorm = float(rlange("i", a_t))
    bmax = _col_max(b_t).cpu().numpy()

    facs: dict = {}
    fac_counts = {t: 0 for t in ladder}
    if factorization is not None:
        facs[factor_tier] = factorization

    def get_fac(tier):
        if tier not in facs:
            facs[tier] = _factorize(a_t, tier, assume, block)
            fac_counts[tier] += 1
        return facs[tier]

    def zero_x():
        return mp.zeros(b_t.shape, target_tier, dtype=lead.dtype,
                        device=lead.device)

    def measure(x):
        r = execute(plan, a_t, x, alpha=-1.0, beta=1.0, c=b_t)
        # LAPACK per-column backward error, worst column governs
        rmax = _col_max(r).cpu().numpy()
        denom = anorm * _col_max(x).cpu().numpy() + bmax
        with np.errstate(divide="ignore", invalid="ignore"):
            cells = np.where(denom > 0, rmax / denom,
                             np.where(rmax == 0, 0.0, np.inf))
        return r, float(np.max(cells))

    def correct(fac, r, x):
        r_f = _as_tier(_cols(r, n), factor_tier)
        d_f = _fsolve(fac, factor_tier, assume, r_f)
        return mp.add(x, _uncols(_as_tier(d_f, target_tier), r))

    x = zero_x()
    history: List[float] = []
    tiers_hist: List[str] = []
    escalations: List[dict] = []
    hazards: List[dict] = []
    stagnations = 0
    converged = False
    prev_berr = None
    best: Optional[Tuple[float, Any]] = None
    it = 0
    x_measured = True

    def hazard(kind, berr):
        hazards.append({
            "kind": kind, "iteration": it, "rung": factor_tier,
            "target": target_tier, "backward_error": berr,
            "finite": math.isfinite(berr),
        })

    while it < max_iters:
        it += 1
        r, berr = measure(x)
        x_measured = True
        history.append(berr)
        tiers_hist.append(factor_tier)
        finite = math.isfinite(berr)
        if finite and (best is None or berr < best[0]):
            best = (berr, x)
        if finite and berr <= tol:
            converged = True
            break
        if (not finite) or (prev_berr is not None
                            and berr > stagnation_ratio * prev_berr):
            # stagnation: this rung can no longer cut the backward error
            stagnations += 1
            nxt = ladder.index(factor_tier) + 1
            capped = (max_escalations is not None
                      and len(escalations) >= max_escalations)
            if nxt <= ladder.index(target_tier) and it < max_iters \
                    and not capped:
                escalations.append({
                    "iteration": it, "from": factor_tier,
                    "to": ladder[nxt],
                    "ratio": berr / prev_berr
                    if (finite and prev_berr) else float("inf"),
                })
                factor_tier = ladder[nxt]
                if not finite:
                    # poisoned iterate: restart from the best finite one
                    x = best[1] if best is not None else zero_x()
                    prev_berr = None
                    continue
            else:
                if capped and nxt <= ladder.index(target_tier):
                    hazard("escalation-capped", berr)
                elif nxt > ladder.index(target_tier):
                    hazard("ladder-exhausted", berr)
                else:
                    hazard("iteration-budget", berr)
                break
        x = correct(get_fac(factor_tier), r, x)
        x_measured = False
        prev_berr = berr

    if x_measured:
        final_berr = history[-1] if history else float("inf")
    else:
        _, final_berr = measure(x)
    if best is not None and not (final_berr <= best[0]):
        x = best[1]  # a diverged last step never worsens the returned x
        final_berr = best[0]
    if not converged and not hazards:
        hazard("iteration-budget", final_berr)
    if vector_rhs:
        x = mp.map_limbs(lambda l: l[..., 0], x)
    info = RefinementInfo(
        converged=converged, iterations=it, target_tier=target_tier,
        tol=float(tol), backward_errors=history, factor_tiers=tiers_hist,
        escalations=escalations,
        factorizations={t: c for t, c in fac_counts.items() if c},
        stagnations=stagnations, final_backward_error=final_berr,
        hazards=hazards,
    )
    return x, info


def rgesv(a, b, *, factor_tier: Optional[str] = None,
          target_tier: Optional[str] = None, assume: str = "gen",
          max_iters: int = 40, tol: Optional[float] = None,
          stagnation_ratio: float = 0.25, block: int = 32,
          max_escalations: Optional[int] = None,
          ladder: Optional[Tuple[str, ...]] = None,
          plan=None, device=None, **plan_overrides):
    """Solve A x = b by factor-cheap / refine-at-target iteration.

    ``a``: (n, n) numpy array, f64 tensor or dd/td/qd value; ``b``: (n,),
    (n, nrhs) or (..., n, nrhs) with leading batch dims.  Numpy input goes
    to ``device`` (``None`` -> CUDA, raising without it); tensors and tier
    values stay on their device.  Semantics
    as :func:`repro.solve.rgesv`: factor once at ``factor_tier``, refine
    the residual at ``target_tier`` through one engine call per iteration,
    escalate one rung on stagnation (``stagnation_ratio``), bounded by
    ``max_escalations`` and walking ``ladder``.  Returns ``(x, info)``.
    """
    if assume not in ("gen", "pos"):
        raise ValueError(f"assume must be 'gen' or 'pos', got {assume!r}")
    return _refine(a, b, factor_tier=factor_tier, target_tier=target_tier,
                   assume=assume, factorization=None, max_iters=max_iters,
                   tol=tol, stagnation_ratio=stagnation_ratio, block=block,
                   max_escalations=max_escalations, ladder=ladder,
                   plan=plan, plan_overrides=plan_overrides, device=device)


def rposv(a, b, **kwargs):
    """SPD convenience wrapper: ``rgesv(..., assume="pos")``."""
    kwargs.setdefault("assume", "pos")
    return rgesv(a, b, **kwargs)


def lu_solve_refined(a, lu, piv, b, *, target_tier: Optional[str] = None,
                     max_iters: int = 40, tol: Optional[float] = None,
                     stagnation_ratio: float = 0.25, block: int = 32,
                     max_escalations: Optional[int] = None,
                     ladder: Optional[Tuple[str, ...]] = None,
                     plan=None, **plan_overrides):
    """Refinement-backed ``lu_solve`` reusing an ``rgetrf`` output (its
    tier is the starting rung); ``a`` must be the matrix that was
    factored."""
    return _refine(a, b, factor_tier=mp.precision_of(lu),
                   target_tier=target_tier, assume="gen",
                   factorization=(lu, piv), max_iters=max_iters, tol=tol,
                   stagnation_ratio=stagnation_ratio, block=block,
                   max_escalations=max_escalations, ladder=ladder,
                   plan=plan, plan_overrides=plan_overrides)


def cholesky_solve_refined(a, l, b, *, target_tier: Optional[str] = None,
                           max_iters: int = 40, tol: Optional[float] = None,
                           stagnation_ratio: float = 0.25, block: int = 32,
                           max_escalations: Optional[int] = None,
                           ladder: Optional[Tuple[str, ...]] = None,
                           plan=None, **plan_overrides):
    """Refinement-backed ``cholesky_solve`` reusing an ``rpotrf`` factor."""
    return _refine(a, b, factor_tier=mp.precision_of(l),
                   target_tier=target_tier, assume="pos",
                   factorization=l, max_iters=max_iters, tol=tol,
                   stagnation_ratio=stagnation_ratio, block=block,
                   max_escalations=max_escalations, ladder=ladder,
                   plan=plan, plan_overrides=plan_overrides)
