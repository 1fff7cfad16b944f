"""The port's blocked LU and refined solve against the JAX reference.

Same numpy inputs, made from a seed, go through ``repro`` and
``repro_torch`` (on the CPU).  The LU's trailing update runs on the
``pallas`` backend (kernel #1; its plain version here), as on the card.
Gates: LAPACK's residual ratio ||PA - LU|| / (n ||A|| u_dd) <= 30
(tests/test_linalg_gates.py), measured exactly over Fractions, and the dd
Hilbert gate 2^-100 (core/accuracy.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import gemm as jgemm
from repro.core import mp as jmp
from repro.core.linalg import lu_solve as jlu_solve
from repro.core.linalg import rgetrf as jrgetrf
from repro.solve import rgesv as jrgesv
from repro.solve import rposv as jrposv
from repro_torch import gemm as tgemm
from repro_torch.core import dd as tdd
from repro_torch.core import mp as tmp
from repro_torch.core.accuracy import (GATES, frac_matmul, frac_matrix,
                                       frac_max_abs, frac_sub, hilbert_f64,
                                       hilbert_relative_error, max_rel_err)
from repro_torch.core.blas import rlange, rsyrk, transpose
from repro_torch.core.linalg import (apply_pivots, lu_solve, rgetrf, rpotrf,
                                     rtrsm)
from repro_torch.gemm import matmul
from repro_torch.interop import limbs_from_numpy
from repro_torch.solve import (cholesky_solve_refined, lu_solve_refined,
                               rgesv, rposv)

pytestmark = pytest.mark.torch_port

THRESH = 30.0  # LAPACK's residual-ratio acceptance constant
U_DD = 2.0 ** -106


@pytest.fixture(autouse=True)
def _hermetic(tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    jgemm.set_default_cache(jgemm.PlanCache(str(tmp_path / "plans.json")))
    tgemm.set_default_cache(tgemm.PlanCache(str(tmp_path / "t.json")))
    yield
    jgemm.set_default_cache(None)
    tgemm.set_default_cache(None)
    torch.set_num_threads(threads)


def _system(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) + n * np.eye(n)


def _to_torch(x):
    return limbs_from_numpy([np.asarray(l) for l in jmp.limbs(x)], "dd",
                            device="cpu")


def _lapack_ratio(a, lu, piv):
    """||P A - L U||_max / (n ||A||_max u_dd), exact over Fractions."""
    n = a.shape[0]
    eye = torch.eye(n, dtype=torch.float64)
    lower = tdd.DD(torch.tril(lu.hi, -1) + eye, torch.tril(lu.lo, -1))
    upper = tdd.DD(torch.triu(lu.hi), torch.triu(lu.lo))
    resid = frac_sub(frac_matrix(apply_pivots(a, piv)),
                     frac_matmul(frac_matrix(lower), frac_matrix(upper)))
    return frac_max_abs(resid) / (n * frac_max_abs(frac_matrix(a)) * U_DD)


def test_rgetrf_pivots_and_lapack_ratio():
    n = 48
    a_np = _system(n, seed=1)
    a = tdd.from_float(a_np, device="cpu")
    lu, piv = rgetrf(a, block=16, backend="pallas", platform="cpu")
    jlu, jpiv = jrgetrf(jmp.from_float(jnp.asarray(a_np), "dd"), block=16,
                        backend="pallas", use_cache=False)
    assert piv.dtype == torch.int64
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
    assert _lapack_ratio(a, lu, piv) <= THRESH
    # the two factors agree to the dd rounding level (the reference's
    # jitted panel contracts FMAs, the port rounds every op)
    assert max_rel_err(lu, _to_torch(jlu)) <= 16 * n * 2.0 ** -104


def test_lu_solve_matches_reference():
    n = 48
    a_np = _system(n, seed=2)
    b_np = np.random.default_rng(3).standard_normal((n, 3))
    a = tdd.from_float(a_np, device="cpu")
    lu, piv = rgetrf(a, block=16, backend="pallas", platform="cpu")
    x = lu_solve(lu, piv, tdd.from_float(b_np, device="cpu"))
    jlu, jpiv = jrgetrf(jmp.from_float(jnp.asarray(a_np), "dd"), block=16,
                        backend="pallas", use_cache=False)
    jx = _to_torch(jlu_solve(jlu, jpiv, jmp.from_float(jnp.asarray(b_np),
                                                       "dd")))
    # cond(A) ~ 1 here: both solutions sit within a few dd ulps of A^-1 b
    assert max_rel_err(x, jx) <= 16 * n * 2.0 ** -104
    assert np.abs(a_np @ tdd.to_float(x).numpy() - b_np).max() < 1e-12


@pytest.mark.parametrize("case", ["converge", "escalate"])
def test_rgesv_follows_reference_ladder(case):
    if case == "converge":
        n = 32
        a = _system(n, seed=4)
        b = a @ np.random.default_rng(5).standard_normal((n, 2))
    else:
        # Hilbert n=14 (cond ~1e18): f64 refinement stalls, one dd rung
        # finishes (tests/test_solve.py's escalation cell)
        n = 14
        a = hilbert_f64(n)
        b = a @ np.ones((n, 1))
    kw = dict(factor_tier="f64", target_tier="dd", max_iters=25)
    x, info = rgesv(a, b, backend="xla", device="cpu", **kw)
    jx, jinfo = jrgesv(a, b, backend="xla", use_cache=False, **kw)
    assert info.converged and jinfo.converged
    assert info.factor_tiers == jinfo.factor_tiers
    assert [(e["iteration"], e["from"], e["to"]) for e in info.escalations] \
        == [(e["iteration"], e["from"], e["to"]) for e in jinfo.escalations]
    assert info.factorizations == jinfo.factorizations
    assert info.iterations == jinfo.iterations
    assert info.final_backward_error <= info.tol
    assert max_rel_err(x, _to_torch(jx)) <= 1e-12
    # per-iteration backward errors within a factor of 4, on both cells:
    # the f64 rung runs the reference's own LAPACK on the CPU (its factors
    # and solves equal the reference's bit for bit, test below), and only
    # XLA's FMA contraction in the jitted residual moves the dd iterates by
    # rounding-level amounts
    for got, want in zip(info.backward_errors, jinfo.backward_errors):
        assert want / 4 <= got <= want * 4


@pytest.mark.parametrize("assume", ["gen", "pos"])
@pytest.mark.parametrize("case", ["hilbert14", "random33"])
def test_f64_rung_equals_reference_lapack(case, assume):
    # the f64 rung's factorization and solve against the reference's own
    # (jitted, as its refinement runs them), bit for bit
    import jax
    from repro.solve import refine as jref

    from repro_torch.solve import refine as tref

    if case == "hilbert14":
        a = hilbert_f64(14)
    else:
        a = _system(33, seed=11)
    if assume == "pos":
        a = a @ a.T + np.eye(a.shape[0])
    r = np.random.default_rng(12).standard_normal((a.shape[0], 3))
    jfac = jref._factorize(jnp.asarray(a), "f64", assume, 32)
    jx = jax.jit(lambda f, b: jref._fsolve(f, "f64", assume, b))(
        jfac, jnp.asarray(r))
    tfac = tref._factorize(torch.as_tensor(a), "f64", assume, 32)
    tx = tref._fsolve(tfac, "f64", assume, torch.as_tensor(r))
    for got, want in zip(tfac if assume == "gen" else [tfac],
                         jfac if assume == "gen" else [jfac]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(tx.numpy().view(np.int64),
                          np.asarray(jx).view(np.int64))


@pytest.mark.parametrize("backend", ["pallas", "ozaki-pallas"])
def test_hilbert_dd_gate(backend):
    assert hilbert_relative_error("dd", 16, backend, device="cpu") \
        <= GATES["dd"]


def _spd(n, seed):
    g = _system(n, seed)
    return g @ g.T + n * np.eye(n)


def test_rposv_follows_reference():
    n = 24
    a = _spd(n, 7)
    b = a @ np.random.default_rng(8).standard_normal((n, 2))
    kw = dict(factor_tier="f64", target_tier="dd")
    x, info = rposv(a, b, backend="xla", device="cpu", **kw)
    jx, jinfo = jrposv(a, b, backend="xla", use_cache=False, **kw)
    assert info.converged and jinfo.converged
    assert info.factorizations == jinfo.factorizations == {"f64": 1}
    assert info.iterations == jinfo.iterations
    assert max_rel_err(x, _to_torch(jx)) <= 1e-12


def test_rpotrf_ratio_and_refined_reuse():
    n = 16
    a_np = _spd(n, 9)
    a = tdd.from_float(a_np, device="cpu")
    chol = rpotrf(a)
    lt = tmp.map_limbs(lambda l: l.T.contiguous(), chol)
    resid = frac_sub(frac_matrix(a),
                     frac_matmul(frac_matrix(chol), frac_matrix(lt)))
    ratio = frac_max_abs(resid) / (n * frac_max_abs(frac_matrix(a)) * U_DD)
    assert ratio <= THRESH
    b = a_np @ np.ones((n, 1))
    x, info = cholesky_solve_refined(a, chol, b, backend="xla")
    assert info.converged and info.factorizations == {}
    assert info.factor_tiers[0] == "dd"
    lu, piv = rgetrf(a, block=8, backend="pallas", platform="cpu")
    x2, info2 = lu_solve_refined(a, lu, piv, b, backend="xla")
    assert info2.converged and info2.iterations <= 3
    assert max_rel_err(x, x2) <= 1e-28


def test_rtrsm_right_and_blas_helpers():
    n = 12
    rng = np.random.default_rng(10)
    u_np = np.triu(rng.standard_normal((n, n))) + n * np.eye(n)
    b_np = rng.standard_normal((5, n))
    u = tdd.from_float(u_np, device="cpu")
    x = rtrsm(u, tdd.from_float(b_np, device="cpu"), side="right",
              lower=False)
    back = matmul(x, u, backend="ref")
    assert max_rel_err(back, tdd.from_float(b_np, device="cpu")) <= 1e-29
    g = tdd.from_float(rng.standard_normal((6, 9)), device="cpu")
    s = rsyrk("u", "n", 1.0, g, 0.0, backend="ref")
    assert max_rel_err(s, matmul(g, transpose(g), backend="ref")) == 0.0
    assert float(rlange("i", g)) == float(np.abs(tdd.to_float(g).numpy())
                                          .sum(1).max())


def test_rposv_f64_cholesky_breakdown_escalates_like_reference():
    # Hilbert n=14 is SPD, but its f64 Cholesky breaks down (14th leading
    # minor): the reference's factor is NaN and the ladder climbs to dd.
    # The port returns NaN too (it used to raise torch's LinAlgError)
    n = 14
    a = hilbert_f64(n)
    b = a @ np.ones((n, 1))
    kw = dict(factor_tier="f64", target_tier="dd", max_iters=4)
    x, info = rposv(a, b, backend="xla", device="cpu", **kw)
    jx, jinfo = jrposv(a, b, backend="xla", use_cache=False, **kw)
    assert info.factor_tiers == jinfo.factor_tiers == ["f64", "f64", "dd",
                                                       "dd"]
    assert info.factorizations == jinfo.factorizations
    assert info.backward_errors[:2] == jinfo.backward_errors[:2]
    assert info.backward_errors[1] == float("inf")
    assert [(e["iteration"], e["from"], e["to"]) for e in info.escalations] \
        == [(e["iteration"], e["from"], e["to"]) for e in jinfo.escalations]


@pytest.mark.parametrize("precision", ["dd", "td"])
def test_rpotrf_and_cholesky_solve_equal_eager_reference(precision):
    # the masked full-length sums of the reference's _potrf/_trsm: the
    # halving tree of mp.sum_ pairs terms by position, so summing only the
    # solved prefix rounded differently from column 5 on (n = 8 covers it)
    import jax
    from repro.core import linalg as jlin
    from repro_torch.core.linalg import cholesky_solve

    rng = np.random.default_rng(21)
    g = rng.standard_normal((8, 8))
    a_np = g @ g.T + 8 * np.eye(8)
    b_np = rng.standard_normal((8, 2))
    a = tmp.from_float(torch.as_tensor(a_np), precision)
    b = tmp.from_float(torch.as_tensor(b_np), precision)
    ja, jb = (jmp.from_float(jnp.asarray(x), precision) for x in (a_np, b_np))
    with jax.disable_jit():
        jl = jlin.rpotrf(ja)
        jx = jlin.cholesky_solve(jl, jb)
    for got, want in ((rpotrf(a), jl), (cholesky_solve(rpotrf(a), b), jx)):
        assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in
                   zip(tmp.limbs(got), jmp.limbs(want)))
