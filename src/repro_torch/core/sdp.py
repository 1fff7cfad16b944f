"""Semidefinite programming via the primal-dual interior point method.

The port of ``repro.core.sdp`` (the paper's §V-B): an SDPA-style Mehrotra
predictor-corrector PDIPM (HRVW/KSH search direction) whose linear algebra
is precision-parameterized.  ``double`` runs on f64 tensors with
``torch.linalg``; ``binary128`` (dd), ``binary192`` (td) and
``binary128+`` (qd) route every GEMM through the engine (one batched call
for the per-constraint stack ``X @ (A_j Z^-1)``), every Cholesky through
``rpotrf``, and the m x m Schur system through the refinement solver
``rposv`` (factor at dd, refine at the tier).  Near the optimum
cond(B) ~ 1/mu^2, which is why the Schur solve must run in extended
precision too.

Standard form:
    primal:  min  C . X      s.t.  A_i . X = b_i,  X psd
    dual:    max  b^T y      s.t.  Z = C - sum_i y_i A_i psd

Schur complement system (KSH):  B dy = rhs,
    B_ij  = tr(A_i X A_j Z^-1)          (symmetric positive definite)
    rhs_i = r_p_i - A_i.(d Z^-1) + A_i.(X R_d Z^-1)
    d     = sigma*mu*I - X Z [- dX dZ for the corrector]
    dZ    = R_d - sum_j dy_j A_j
    dX    = (d - X dZ) Z^-1, symmetrized.

GEMM backend: the default plan pins ``backend="xla"`` as the reference
does: Ozaki's error is absolute per row, and near the optimum that loses
the bits the method needs; per-element (relative-error) backends keep
them.  ``gemm_overrides={"backend": "pallas"}`` puts every product on
kernel #1, per-element too, and is the card's configuration.

The reference jits its multi-limb helpers; here they are plain functions
on tensors, and on the card each tier op is one fused kernel
(``kernels/mpops.py``).  ``solve_sdp(device=None)`` runs on the CUDA card
and raises without one (tests pass ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from .._device import resolve_device
from . import dd, mp, qd, td
from .blas import transpose
from .linalg import cholesky_solve, rpotrf

__all__ = ["SDPProblem", "SDPResult", "solve_sdp", "random_sdp",
           "theta_problem"]


# --------------------------------------------------------------------------
# precision backends (matrices: (n,n); stacks: (m,n,n); vectors: (m,))
# --------------------------------------------------------------------------


class _F64Ops:
    name = "double"

    def __init__(self, device):
        self.device = device

    def wrap(self, a_np):
        return torch.as_tensor(np.asarray(a_np, np.float64),
                               device=self.device)

    def eye(self, n, scale=1.0):
        return torch.eye(n, dtype=torch.float64, device=self.device) * scale

    def matmul(self, a, b):
        return a @ b

    add = staticmethod(lambda a, b: a + b)
    sub = staticmethod(lambda a, b: a - b)

    def smul(self, s, a):
        return s * a

    def trace_dot(self, a, b):
        return torch.sum(a * b)

    def stack_trace(self, stack, mat):
        """(m,) vector of tr(A_i mat) = sum(A_i * mat^T)."""
        return torch.einsum("ikl,lk->i", stack, mat)

    def combine(self, vec, stack):
        """sum_i vec_i A_i."""
        return torch.einsum("i,ikl->kl", vec, stack)

    def pairwise_trace(self, stack, vstack):
        """B_ij = tr(A_i V_j) = sum_kl A_i[kl] V_j[lk]."""
        return torch.einsum("ikl,jlk->ij", stack, vstack)

    def chol(self, a):
        # a breakdown gives NaN, as jnp.linalg.cholesky does, not an error
        low, info = torch.linalg.cholesky_ex(a)
        return low if int(info) == 0 else torch.full_like(a, float("nan"))

    def chol_solve(self, l, b):
        y = torch.linalg.solve_triangular(l, b, upper=False)
        return torch.linalg.solve_triangular(l.T, y, upper=True)

    def solve_spd(self, bmat, rhs):
        return self.chol_solve(self.chol(bmat), rhs[:, None])[:, 0]

    def t(self, a):
        return a.transpose(-1, -2)

    def to_float(self, a) -> float:
        return float(a)

    def to_np(self, a):
        return a.detach().cpu().numpy().astype(np.float64)

    def has_nan(self, a) -> bool:
        return bool(torch.isnan(a).any())

    def max_abs(self, a) -> float:
        return float(torch.abs(a).max())


# the reference's jitted multi-limb helpers (sdp.py's _ml_*), as plain
# functions


def _ml_smul_ml(s, a):
    return mp.mul(mp.broadcast_to(s, a.shape), a)


def _ml_trace_dot(a, b):
    return mp.sum_(mp.mul(a, b))


def _ml_stack_trace(stack, mat):
    m = stack.shape[0]
    tm = mp.map_limbs(lambda l: l.transpose(-1, -2)[None], mat)
    prod = mp.mul(stack, tm)
    return mp.sum_(prod.reshape(m, -1), axis=1)


def _ml_combine(vec, stack):
    w = mp.map_limbs(lambda l: l[:, None, None], vec)
    return mp.sum_(mp.mul(w, stack), axis=0)


def _ml_pairwise_trace(stack, vstack):
    """B_ij = sum_kl A_i[kl] V_j[lk]: an (m, m, n, n) product reduced over
    its last n*n.  At SDPLIB's theta1 size each limb of the product is
    216 MB; the broadcast inputs are views until the multiply, and the
    product goes as soon as the reduction returns."""
    m = stack.shape[0]
    a = mp.map_limbs(lambda l: l[:, None], stack)                # (m,1,n,n)
    v = mp.map_limbs(lambda l: l.transpose(-1, -2)[None], vstack)  # (1,m,n,n)
    return mp.sum_(mp.mul(a, v).reshape(m, m, -1), axis=2)


class _MLOps:
    """Shared multi-limb ops backend; subclasses fix the tier module."""

    mod = dd  # overridden
    # Schur solves factor at this rung and refine at the tier's own
    # precision (solve.rposv); the ladder re-factors at the tier itself
    # when cond(B) ~ 1/mu^2 outgrows the rung near the optimum
    schur_factor_tier = "dd"

    def __init__(self, device, plan_overrides: dict | None = None):
        self.device = device
        # planner overrides (default: xla, the reference's pin; an explicit
        # {} means full auto planning)
        self.plan_overrides = dict(plan_overrides) \
            if plan_overrides is not None else {"backend": "xla"}
        self.schur_stats = {"solves": 0, "iterations": 0, "escalations": 0,
                            "factorizations": {}}

    def wrap(self, a_np):
        return self.mod.from_float(torch.as_tensor(
            np.asarray(a_np, np.float64), device=self.device))

    def eye(self, n, scale=1.0):
        return self.mod.from_float(torch.eye(
            n, dtype=torch.float64, device=self.device) * scale)

    def matmul(self, a, b):
        # (..., n, n) leading batch dims take the engine's batched path:
        # the per-constraint stack runs as one call
        from ..gemm import matmul

        return matmul(a, b, **self.plan_overrides)

    add = staticmethod(mp.add)
    sub = staticmethod(mp.sub)

    def smul(self, s, a):
        if isinstance(s, (dd.DD, td.TD, qd.QD)):
            return _ml_smul_ml(mp.promote(s, mp.precision_of(a)), a)
        return mp.mul_float(a, torch.tensor(float(s), dtype=torch.float64,
                                            device=self.device))

    trace_dot = staticmethod(_ml_trace_dot)
    stack_trace = staticmethod(_ml_stack_trace)
    combine = staticmethod(_ml_combine)
    pairwise_trace = staticmethod(_ml_pairwise_trace)

    def chol(self, a):
        return rpotrf(a)

    def chol_solve(self, l, b):
        return cholesky_solve(l, b)

    def solve_spd(self, bmat, rhs):
        # the Schur system through the tiered refinement solver: factor
        # once at the cheap rung, refine residuals at this tier through the
        # engine, escalate on stagnation
        from ..solve import rposv

        dy, info = rposv(bmat, rhs, factor_tier=self.schur_factor_tier,
                         target_tier=mp.precision_of(bmat), max_iters=12,
                         **self.plan_overrides)
        st = self.schur_stats
        st["solves"] += 1
        st["iterations"] += info.iterations
        st["escalations"] += len(info.escalations)
        for tier, cnt in info.factorizations.items():
            st["factorizations"][tier] = \
                st["factorizations"].get(tier, 0) + cnt
        last_measured = info.backward_errors[-1] \
            if info.backward_errors else float("nan")
        topped_out = bool(info.factor_tiers) and \
            info.factor_tiers[-1] == info.target_tier
        if not info.converged and topped_out \
                and not math.isfinite(last_measured) \
                and not info.final_backward_error < 0.5:
            # the ladder topped out with a broken factorization and no
            # usable refined direction: keep the direct solve's failure
            # signal, so the PDIPM loop stops at its precision floor
            return mp.map_limbs(lambda x: torch.full_like(x, float("nan")),
                                dy)
        return dy

    def t(self, a):
        return transpose(a)

    def to_float(self, a) -> float:
        return float(mp.to_float(a))

    def to_np(self, a):
        return mp.to_float(a).detach().cpu().numpy().astype(np.float64)

    def has_nan(self, a) -> bool:
        return any(bool(torch.isnan(l).any()) for l in mp.limbs(a))

    def max_abs(self, a) -> float:
        return float(torch.abs(mp.to_float(a)).max())


class _DDOps(_MLOps):
    """binary128 backend: double-word (~106-bit) limbs, the paper's tier."""

    name = "binary128"
    mod = dd


class _TDOps(_MLOps):
    """binary192 backend: triple-word (~159-bit) limbs."""

    name = "binary192"
    mod = td


class _QDOps(_MLOps):
    """binary128+ backend: quad-word (~212-bit) limbs."""

    name = "binary128+"
    mod = qd


def _ops(precision: str, gemm_overrides: dict | None = None, device=None):
    if precision in ("double", "f64"):
        return _F64Ops(device)
    if precision in ("binary128", "dd", "dd64"):
        return _DDOps(device, gemm_overrides)
    if precision in ("binary192", "td", "td64"):
        return _TDOps(device, gemm_overrides)
    if precision in ("binary128+", "qd", "qd64"):
        return _QDOps(device, gemm_overrides)
    raise ValueError(f"unknown precision {precision!r}")


# --------------------------------------------------------------------------
# problems (numpy, exact input data; the reference's generators, copied)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SDPProblem:
    """min C.X s.t. A_i.X = b_i, X psd.  All numpy f64 (exact input data)."""

    c: np.ndarray            # (n, n) symmetric
    a: List[np.ndarray]      # m matrices (n, n) symmetric
    b: np.ndarray            # (m,)
    opt: float | None = None  # known optimal value, if any
    name: str = "sdp"

    @property
    def n(self) -> int:
        return self.c.shape[0]

    @property
    def m(self) -> int:
        return len(self.a)


@dataclasses.dataclass
class SDPResult:
    x: np.ndarray
    y: np.ndarray
    z: np.ndarray
    iterations: int
    relative_gap: float
    p_feas_err: float
    d_feas_err: float
    primal_obj: float
    dual_obj: float
    converged: bool
    history: list
    # refinement telemetry of the Schur solves (multi-limb precisions
    # only): solves / refine iterations / escalations and the per-rung
    # factorization counts
    schur_stats: dict | None = None


def random_sdp(n: int, m: int, seed: int = 0, rank: int | None = None,
               degeneracy: float = 0.0) -> SDPProblem:
    """Random SDP with a KNOWN strictly-complementary optimal pair.

    X* = Q diag(lam, 0) Q^T (rank r), Z* = Q diag(0, omega) Q^T, X* Z* = 0;
    b_i = A_i . X*, C = Z* + sum_i y*_i A_i  ==> opt = C . X* = b^T y*.
    ``degeneracy`` > 0 makes A_2 nearly parallel to A_1, so cond(B) ~
    1/degeneracy^2 (the paper's "binary128 or higher" as a dial).
    """
    rng = np.random.default_rng(seed)
    r = rank if rank is not None else max(1, n // 2)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = rng.uniform(0.5, 2.0, size=r)
    omega = rng.uniform(0.5, 2.0, size=n - r)
    x_star = q[:, :r] @ np.diag(lam) @ q[:, :r].T
    z_star = q[:, r:] @ np.diag(omega) @ q[:, r:].T
    a_mats = []
    for _ in range(m):
        g = rng.standard_normal((n, n))
        a_mats.append((g + g.T) / 2)
    if degeneracy and m >= 2:
        a_mats[1] = a_mats[0] + degeneracy * a_mats[1]
    y_star = rng.standard_normal(m)
    b = np.array([np.sum(ai * x_star) for ai in a_mats])
    c = z_star + sum(yi * ai for yi, ai in zip(y_star, a_mats))
    opt = float(np.sum(c * x_star))
    return SDPProblem(c=c, a=a_mats, b=b, opt=opt, name=f"rand{n}x{m}")


def theta_problem(n_vertices: int, edge_prob: float = 0.4,
                  seed: int = 0) -> SDPProblem:
    """Lovasz theta SDP (the SDPLIB 'theta*' family): max J.X s.t. tr X = 1,
    X_ij = 0 on edges, X psd.  Returned in min form (C = -J)."""
    rng = np.random.default_rng(seed)
    n = n_vertices
    edges = [(i, j) for i in range(n) for j in range(i + 1, n)
             if rng.random() < edge_prob]
    a_mats = [np.eye(n)]
    b = [1.0]
    for (i, j) in edges:
        e = np.zeros((n, n))
        e[i, j] = e[j, i] = 0.5
        a_mats.append(e)
        b.append(0.0)
    c = -np.ones((n, n))
    return SDPProblem(c=c, a=a_mats, b=np.array(b), opt=None,
                      name=f"theta{n}")


# --------------------------------------------------------------------------
# solver
# --------------------------------------------------------------------------


def _step_length(ops, mat, dmat, gamma: float) -> float:
    """gamma * (largest alpha <= 1 with mat + alpha*dmat psd), by
    Cholesky-test backtracking."""
    alpha = 1.0
    for _ in range(80):
        trial = ops.add(mat, ops.smul(alpha, dmat))
        l = ops.chol(trial)
        if not ops.has_nan(l):
            return gamma * alpha
        alpha *= 0.7
    return 1e-8


def solve_sdp(prob: SDPProblem, *, precision: str = "binary128",
              gemm_overrides: dict | None = None, max_iters: int = 120,
              tol_gap: float | None = None, gamma: float = 0.9,
              schur_factor_tier: str | None = None, verbose: bool = False,
              device=None, mesh=None, comm=None,
              k_stream=None) -> SDPResult:
    """SDPA-style Mehrotra predictor-corrector PDIPM (precision-generic).

    ``precision``: ``"double"`` (f64), ``"binary128"`` (dd),
    ``"binary192"`` (td) or ``"binary128+"`` (qd).  ``gemm_overrides``
    feeds the engine's planner for every extended-precision product
    (default pins backend="xla"; ``{"backend": "pallas"}`` runs kernel #1).
    ``schur_factor_tier`` overrides the rung the Schur system is factored
    at (default dd).  ``device=None`` means the CUDA card (raising without
    one); ``device="cpu"`` runs on the CPU.  ``mesh``/``comm``/``k_stream``
    (SUMMA sharding of the Schur stacks) are not ported yet.
    """
    if mesh is not None or comm is not None or k_stream is not None:
        raise NotImplementedError(
            "mesh=/comm=/k_stream= are not ported to repro_torch yet "
            "(ROADMAP.md, Open items: 'SUMMA sharding + out-of-core K "
            "streaming')")
    dev = resolve_device(device)
    ops = _ops(precision, gemm_overrides, dev)
    if schur_factor_tier is not None:
        if not hasattr(ops, "schur_factor_tier"):
            raise ValueError(
                "schur_factor_tier only applies to the extended-precision "
                "backends (binary128/binary192/binary128+)")
        ops.schur_factor_tier = schur_factor_tier
    if tol_gap is None:
        tol_gap = {"binary128+": 1e-40, "binary192": 1e-32,
                   "binary128": 1e-25}.get(ops.name, 1e-12)
    n, m = prob.n, prob.m

    c = ops.wrap(prob.c)
    astack = ops.wrap(np.stack(prob.a))          # (m, n, n)
    b_np = prob.b.astype(np.float64)
    b_vec = ops.wrap(b_np)                       # (m,)

    scale = max(1.0, float(np.abs(prob.c).max()), float(np.abs(prob.b).max()))
    x = ops.eye(n, 10.0 * scale)
    z = ops.eye(n, 10.0 * scale)
    y = ops.wrap(np.zeros(m))

    history = []
    gap = pfeas = dfeas = np.inf
    pobj = dobj = 0.0
    best = None  # (gap, pfeas, dfeas, pobj, dobj, x, y, z, it)
    it = 0
    for it in range(1, max_iters + 1):
        r_d = ops.sub(ops.sub(c, ops.combine(y, astack)), z)   # C - sum yA - Z
        r_p = ops.sub(b_vec, ops.stack_trace(astack, x))       # (m,)

        mu_f = ops.to_float(ops.trace_dot(x, z)) / n
        pobj_b = ops.trace_dot(c, x)
        dobj_b = ops.trace_dot(b_vec, y)
        pobj = ops.to_float(pobj_b)
        dobj = ops.to_float(dobj_b)
        # the gap difference in backend precision (an f64 subtraction of
        # the objectives floors the metric at ~1e-16 relative)
        gap_abs = abs(ops.to_float(ops.sub(pobj_b, dobj_b)))
        gap = gap_abs / max(1.0, (abs(pobj) + abs(dobj)) / 2)
        pfeas = ops.max_abs(r_p)
        dfeas = ops.max_abs(r_d)
        history.append((it, gap, pfeas, dfeas, mu_f))
        if verbose:
            print(f"  it {it:3d}  gap {gap:9.2e}  pfeas {pfeas:9.2e}"
                  f"  dfeas {dfeas:9.2e}  mu {mu_f:9.2e}")
        if best is None or gap < best[0]:
            best = (gap, pfeas, dfeas, pobj, dobj, x, y, z, it)
        if gap < tol_gap and pfeas < 1e-3 * np.sqrt(tol_gap) * scale \
                and dfeas < 1e-3 * np.sqrt(tol_gap) * scale:
            break
        if not np.isfinite(mu_f) or mu_f <= 0 or not np.isfinite(gap):
            break  # numerical floor of the precision backend
        if best is not None and gap > 1e4 * best[0] and best[0] < 1e-6:
            break  # diverging past the precision floor: stop at best iterate

        # factorizations shared by predictor + corrector
        lz = ops.chol(z)
        xz = ops.matmul(x, z)
        # V_j = X A_j Z^-1 = X (Z^-1 A_j)^T  -> B_ij = tr(A_i V_j)
        u = ops.chol_solve(lz, _hstack(astack, n, m))          # Z^-1 A_j
        s_stack = ops.t(_unstack(u, n, m))                     # A_j Z^-1
        del u
        # one batched GEMM over the constraint stack: X @ (A_j Z^-1) for
        # every j in a single engine call
        vstack = ops.matmul(x, s_stack)                        # (m, n, n)
        del s_stack
        bmat = ops.pairwise_trace(astack, vstack)
        del vstack
        bmat = ops.smul(0.5, ops.add(bmat, ops.t(bmat)))

        x_rd = ops.matmul(x, r_d)
        xrd_zinv = ops.t(ops.chol_solve(lz, ops.t(x_rd)))      # X R_d Z^-1

        def solve_direction(d):
            d_zinv = ops.t(ops.chol_solve(lz, ops.t(d)))       # d Z^-1
            rhs = ops.add(
                ops.sub(r_p, ops.stack_trace(astack, d_zinv)),
                ops.stack_trace(astack, xrd_zinv),
            )
            dy = ops.solve_spd(bmat, rhs)
            dz = ops.sub(r_d, ops.combine(dy, astack))
            rhs_x = ops.sub(d, ops.matmul(x, dz))
            dx = ops.t(ops.chol_solve(lz, ops.t(rhs_x)))  # (d - X dZ) Z^-1
            dx = ops.smul(0.5, ops.add(dx, ops.t(dx)))
            return dy, dx, dz

        # predictor (affine scaling): d = -X Z, with an adaptive gamma that
        # approaches 1 near the optimum
        g_it = max(gamma, 1.0 - 1e-2 * max(mu_f, 1e-30) ** 0.25) \
            if mu_f < 1e-4 else gamma
        g_it = min(g_it, 1.0 - 1e-12)
        dy_a, dx_a, dz_a = solve_direction(ops.smul(-1.0, xz))
        ap = _step_length(ops, x, dx_a, g_it)
        ad = _step_length(ops, z, dz_a, g_it)
        x_trial = ops.add(x, ops.smul(ap, dx_a))
        z_trial = ops.add(z, ops.smul(ad, dz_a))
        mu_aff = ops.to_float(ops.trace_dot(x_trial, z_trial)) / n
        ratio = min(1.0, max(mu_aff / max(mu_f, 1e-307), 0.0))
        sigma = max(ratio ** 3, 1e-12)

        # corrector: d = sigma*mu*I - X Z - dX_a dZ_a
        d_cor = ops.sub(ops.sub(ops.eye(n, sigma * mu_f), xz),
                        ops.matmul(dx_a, dz_a))
        dy, dx, dz = solve_direction(d_cor)
        ap = _step_length(ops, x, dx, g_it)
        ad = _step_length(ops, z, dz, g_it)
        # equal primal/dual steps keep the X/Z eigen-pairings on the
        # central path (see the reference)
        a_eq = min(ap, ad)

        x = ops.add(x, ops.smul(a_eq, dx))
        y = ops.add(y, ops.smul(a_eq, dy))
        z = ops.add(z, ops.smul(a_eq, dz))

    # NaN-robust: fall back to the best iterate unless the final one is
    # strictly better
    if best is not None and not (gap <= best[0]):
        gap, pfeas, dfeas, pobj, dobj, x, y, z, _ = best
    return SDPResult(
        x=ops.to_np(x), y=ops.to_np(y), z=ops.to_np(z), iterations=it,
        relative_gap=float(gap), p_feas_err=float(pfeas),
        d_feas_err=float(dfeas), primal_obj=pobj, dual_obj=dobj,
        converged=bool(gap < tol_gap), history=history,
        schur_stats=getattr(ops, "schur_stats", None),
    )


def _hstack(astack, n: int, m: int):
    """(m,n,n) -> (n, m*n) horizontal concat of the A_j."""
    def f(x):
        return x.permute(1, 0, 2).reshape(n, m * n)
    if isinstance(astack, (dd.DD, td.TD, qd.QD)):
        return mp.map_limbs(f, astack)
    return f(astack)


def _unstack(v, n: int, m: int):
    """(n, m*n) -> (m, n, n)."""
    def f(x):
        return x.reshape(n, m, n).permute(1, 0, 2)
    if isinstance(v, (dd.DD, td.TD, qd.QD)):
        return mp.map_limbs(f, v)
    return f(v)
