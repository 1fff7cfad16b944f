"""The port's SDP interior-point solver against the JAX reference.

Same problems (the port's generators equal the reference's, checked
below) go through ``repro.core.sdp.solve_sdp`` and the port's on the CPU,
on the card's GEMM configuration ``{"backend": "pallas"}`` (kernel #1's
plain version here) and, at binary128, on kernel #2 with bf16 slices and
f32 pair dots (``ozaki-pallas`` with the narrow overrides; chip_smoke.py
phase 10 holds the card's whole theta1 history to the reference's, run
eagerly).  Tolerances:
  * binary128: the same iteration count and Schur statistics, the
    per-iteration gap / primal / dual infeasibility / mu equal bit for
    bit over the first iterations (as measured), and X, y and Z within
    2^-100 of their largest entry, a few dd ulps: XLA's FMA contraction
    inside the reference's jitted tier ops moves low limbs by rounding-
    level amounts (measured: y and Z equal, one entry of theta8's X
    6.0e-34 apart against a largest entry of 0.178);
  * double: equal iteration count; while the gap is above 1e-5, gap and
    mu within 1e-8 relative and the infeasibilities within 1e-11
    absolute (f64 round-off of O(1) residuals; torch's and XLA's f64
    sums round differently, and the difference grows as X and Z go
    singular), then both stall in the f64 floor, which is the paper's
    claim: gap in [1e-13, 1e-8];
  * one binary128 step on kernel #2's narrow plan against the reference
    run eagerly (``jax.disable_jit()``, no FMA contraction): X, y and Z
    bit for bit;
  * the building blocks of one iteration (stack_trace, combine,
    pairwise_trace, the batched matmul) at td and qd, against the
    reference's function bodies run eagerly: bit for bit, the order being
    the same.
The reference's binary192 and binary128+ runs, and the port's full-length
extended-precision runs (the Table V receipt takes 80 dd iterations, about
3 minutes here), are too slow for the CPU: chip_smoke.py phase 9 runs the
receipts of tests/test_sdp.py on the card (theta1's shape at binary128 and
binary128+, the degenerate binary128+ receipt and the binary192 receipt).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import gemm as jgemm
from repro.core import mp as jmp
from repro.core import sdp as jsdp
from repro_torch import gemm as tgemm
from repro_torch.core import mp as tmp
from repro_torch.core import sdp as tsdp
from repro_torch.interop import limbs_from_numpy

pytestmark = pytest.mark.torch_port

PROBLEMS = {"theta8": ("theta_problem", (8, 0.4), {"seed": 2}),
            "rand6x4": ("random_sdp", (6, 4), {"seed": 3})}


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


def _problems(name):
    fn, args, kw = PROBLEMS[name]
    return getattr(jsdp, fn)(*args, **kw), getattr(tsdp, fn)(*args, **kw)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_generators_equal_reference(name):
    jp, tp = _problems(name)
    np.testing.assert_array_equal(tp.c, jp.c)
    np.testing.assert_array_equal(np.stack(tp.a), np.stack(jp.a))
    np.testing.assert_array_equal(tp.b, jp.b)
    assert (tp.n, tp.m, tp.opt, tp.name) == (jp.n, jp.m, jp.opt, jp.name)


def _close(u, v, rtol):
    return abs(u - v) <= rtol * max(abs(u), abs(v))


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_binary128_follows_reference(name):
    jp, tp = _problems(name)
    kw = dict(precision="binary128", gemm_overrides={"backend": "pallas"},
              max_iters=3)
    jr = jsdp.solve_sdp(jp, **kw)
    tr = tsdp.solve_sdp(tp, device="cpu", **kw)
    assert tr.iterations == jr.iterations == 3
    assert tr.schur_stats == jr.schur_stats
    assert tr.schur_stats["factorizations"] == {"dd": 6}
    assert tr.history == jr.history
    for got, want in ((tr.x, jr.x), (tr.y, jr.y), (tr.z, jr.z)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got, want, rtol=0, atol=2.0 ** -100 * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_binary128_narrow_follows_reference(name):
    # the Schur stacks and residuals on kernel #2 with bf16 slices and f32
    # pair dots (its plain version here), against the reference's same
    # plan in interpret mode: the tolerances of the pallas plan above
    jp, tp = _problems(name)
    kw = dict(precision="binary128", max_iters=3, gemm_overrides={
        "backend": "ozaki-pallas", "slice_dtype": "bfloat16",
        "acc_dtype": "float32"})
    jr = jsdp.solve_sdp(jp, **kw)
    tr = tsdp.solve_sdp(tp, device="cpu", **kw)
    assert tr.iterations == jr.iterations == 3
    assert tr.schur_stats == jr.schur_stats
    assert tr.history == jr.history
    for got, want in ((tr.x, jr.x), (tr.y, jr.y), (tr.z, jr.z)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got, want, rtol=0, atol=2.0 ** -100 * np.abs(want).max())


def test_binary128_narrow_step_equals_eager_reference():
    # one whole interior-point step on the narrow plan (the Cholesky
    # factors, the Schur stacks on kernel #2, the refined Schur solve, the
    # step lengths) against the reference run eagerly, where every
    # operation rounds on its own as the port's do: X, y, Z as the solvers
    # return them, bit for bit.
    # chip_smoke.py phase 10 holds theta1's whole history to the same
    # eager reference on the card; eagerly a step takes about a minute
    # here, so the CPU checks one
    jp, tp = _problems("rand6x4")
    kw = dict(precision="binary128", max_iters=1, gemm_overrides={
        "backend": "ozaki-pallas", "slice_dtype": "bfloat16",
        "acc_dtype": "float32"})
    with jax.disable_jit():
        jr = jsdp.solve_sdp(jp, **kw)
    tr = tsdp.solve_sdp(tp, device="cpu", **kw)
    assert tr.history == jr.history
    assert tr.schur_stats == jr.schur_stats
    for got, want in ((tr.x, jr.x), (tr.y, jr.y), (tr.z, jr.z)):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_double_follows_reference_then_stalls(name):
    jp, tp = _problems(name)
    jr = jsdp.solve_sdp(jp, precision="double", max_iters=40)
    tr = tsdp.solve_sdp(tp, precision="double", max_iters=40, device="cpu")
    assert tr.iterations == jr.iterations
    assert tr.schur_stats is None
    for th, jh in zip(tr.history, jr.history):
        if jh[1] < 1e-5:
            break
        # gap and mu relative; the infeasibilities are residuals of O(1)
        # data, whose f64 round-off is absolute
        assert _close(th[1], jh[1], 1e-8) and _close(th[4], jh[4], 1e-8), \
            (th, jh)
        assert abs(th[2] - jh[2]) <= 1e-11 and abs(th[3] - jh[3]) <= 1e-11
    # the paper's claim for double precision: the gap stalls, 1e-13..1e-8
    assert 1e-13 < tr.relative_gap < 1e-8
    assert 1e-13 < jr.relative_gap < 1e-8


def test_double_on_random_sdp_known_optimum():
    # tests/test_sdp.py's receipt, on the port
    prob = tsdp.random_sdp(8, 5, seed=3)
    res = tsdp.solve_sdp(prob, precision="double", max_iters=40,
                         device="cpu")
    assert res.relative_gap < 1e-6
    assert abs(res.primal_obj - prob.opt) < 1e-5 * max(1, abs(prob.opt))


def _tier_stack(shape, precision, seed):
    """Normalized tier limbs with signal in every limb (numpy)."""
    rng = np.random.default_rng(seed)
    x = tmp.from_float(torch.as_tensor(rng.standard_normal(shape)),
                       precision)
    for i in range(1, tmp.PRECISIONS[precision]):
        x = tmp.add(x, tmp.from_float(torch.as_tensor(
            rng.standard_normal(shape) * 2.0 ** (-53 * i)), precision))
    return [l.numpy() for l in tmp.limbs(x)]


def _both(limbs, precision):
    return (jmp.from_limbs([jnp.asarray(l) for l in limbs]),
            limbs_from_numpy(limbs, precision, "cpu"))


def _bitwise(t, j, precision):
    want = limbs_from_numpy([np.asarray(l) for l in jmp.limbs(j)],
                            precision, "cpu")
    return all(torch.equal(a, b) for a, b in zip(tmp.limbs(t),
                                                 tmp.limbs(want)))


@pytest.mark.parametrize("precision", ["td", "qd"])
def test_iteration_building_blocks_bitwise(precision):
    m, n = 3, 4
    ja, ta = _both(_tier_stack((m, n, n), precision, 20), precision)
    jx, tx = _both(_tier_stack((n, n), precision, 21), precision)
    jv, tv = _both(_tier_stack((m,), precision, 22), precision)
    js, ts = _both(_tier_stack((m, n, n), precision, 23), precision)
    with jax.disable_jit():
        j_st = jsdp._ml_stack_trace(ja, jx)
        j_cb = jsdp._ml_combine(jv, ja)
        j_pt = jsdp._ml_pairwise_trace(ja, js)
        j_mm = jgemm.matmul(jx, js, backend="xla", use_cache=False)
    assert _bitwise(tsdp._ml_stack_trace(ta, tx), j_st, precision)
    assert _bitwise(tsdp._ml_combine(tv, ta), j_cb, precision)
    assert _bitwise(tsdp._ml_pairwise_trace(ta, ts), j_pt, precision)
    # the batched X @ (A_j Z^-1) stack, one engine call on the port too
    ops = tsdp._ops({"td": "binary192", "qd": "binary128+"}[precision],
                    {"backend": "xla"}, torch.device("cpu"))
    t_mm = ops.matmul(tx, ts)
    assert t_mm.shape == (m, n, n)
    assert _bitwise(t_mm, j_mm, precision)


def test_solve_sdp_options():
    prob = tsdp.random_sdp(4, 2, seed=0)
    with pytest.raises(ValueError, match="schur_factor_tier"):
        tsdp.solve_sdp(prob, precision="double", schur_factor_tier="td",
                       device="cpu")
    with pytest.raises(ValueError, match="precision"):
        tsdp.solve_sdp(prob, precision="binary64", device="cpu")
    for kw in ({"mesh": object()}, {"comm": "ring"}, {"k_stream": 8}):
        with pytest.raises(NotImplementedError, match="SUMMA"):
            tsdp.solve_sdp(prob, device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tsdp.solve_sdp(prob)


def test_theta_problem_structure():
    prob = tsdp.theta_problem(6, 0.5, seed=0)
    assert prob.a[0].shape == (6, 6)
    assert np.allclose(prob.a[0], np.eye(6))
    assert prob.b[0] == 1.0
    for a in prob.a:
        assert np.allclose(a, a.T)
