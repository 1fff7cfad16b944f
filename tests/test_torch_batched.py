"""Batched execution in the port: the engine's batch axis and the refined
solve's batched right-hand sides, against the JAX reference.

Same numpy limbs, made from a seed, go through ``repro`` and
``repro_torch`` (on the CPU, where both kernel wrappers run their plain
versions).  Tolerances:
  * port batched == port looped, bit for bit, on every backend and tier:
    each batch entry runs the same per-element arithmetic in the same
    order (the CUDA kernels are held to the same on the card by
    ``chip_smoke.py``);
  * the port's ``ref`` backend batched == an eager loop of the reference's
    oracle, bit for bit (both round op for op);
  * the port against the reference's jitted batched ``execute`` within the
    conformance bound 16 * k * ulp(tier) (tests/test_conformance.py:43):
    XLA contracts FMAs inside the jitted tier arithmetic.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import gemm as jgemm
from repro.core import mp as jmp
from repro.kernels import ref as jref
from repro.solve import rgesv as jrgesv
from repro_torch import gemm as tgemm
from repro_torch.core import mp as tmp
from repro_torch.core.accuracy import max_rel_err
from repro_torch.interop import limbs_from_numpy, limbs_to_numpy
from repro_torch.solve import rgesv

pytestmark = pytest.mark.torch_port

ULP = {"dd": 2.0 ** -104, "td": 2.0 ** -155, "qd": 2.0 ** -205}
LAYOUTS = {"a": ((3, 7, 9), (9, 5)), "b": ((7, 9), (3, 9, 5)),
           "both": ((3, 7, 9), (3, 9, 5))}


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


@functools.lru_cache(maxsize=None)
def _limbs(shape, precision, seed):
    """Random tier limbs with signal in every limb (numpy, read-only)."""
    rng = np.random.default_rng(seed)
    x = tmp.from_float(torch.as_tensor(rng.standard_normal(shape)),
                       precision)
    for i in range(1, tmp.PRECISIONS[precision]):
        x = tmp.add(x, tmp.from_float(torch.as_tensor(
            rng.standard_normal(shape) * 2.0 ** (-53 * i)), precision))
    out = limbs_to_numpy(x)
    for l in out:
        l.setflags(write=False)
    return tuple(out)


def _cell(layout, precision):
    """(a, b, c, alpha, beta) numpy limbs for one batched cell."""
    sa, sb = LAYOUTS[layout]
    m, n = sa[-2], sb[-1]
    return (_limbs(sa, precision, 1), _limbs(sb, precision, 2),
            _limbs((3, m, n), precision, 3), _limbs((), precision, 4),
            _limbs((), precision, 5))


def _torch(ls, precision):
    return limbs_from_numpy(ls, precision, device="cpu")


def _jax(ls):
    return jmp.from_limbs([jnp.asarray(l) for l in ls])


def _bitwise(got, want):
    return all(torch.equal(g, w) for g, w in zip(tmp.limbs(got),
                                                 tmp.limbs(want)))


BACKENDS = [(be, p) for p in ("dd", "td", "qd")
            for be in ("pallas", "ozaki-pallas", "xla", "ozaki", "ref")
            if not (be == "ozaki" and p == "qd")]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("backend,precision", BACKENDS)
def test_batched_equals_looped(backend, precision, layout):
    a, b, c, alpha, beta = [_torch(x, precision)
                            for x in _cell(layout, precision)]
    got = tgemm.matmul(a, b, backend=backend, alpha=alpha, beta=beta, c=c)
    assert got.shape == (3, 7, 5)
    for i in range(3):
        ai = a[i] if len(a.shape) == 3 else a
        bi = b[i] if len(b.shape) == 3 else b
        want = tgemm.matmul(ai, bi, backend=backend, alpha=alpha,
                            beta=beta, c=c[i])
        assert _bitwise(got[i], want), i


@pytest.mark.parametrize("precision", ["dd", "td", "qd"])
def test_batched_matches_reference(precision):
    # the reference's batched execute (vmap of its interpret-mode Pallas
    # kernel) on the cell with both operands batched and the full epilogue
    a, b, c, alpha, beta = _cell("both", precision)
    want = jgemm.matmul(_jax(a), _jax(b), backend="pallas", use_cache=False,
                        alpha=_jax(alpha), beta=_jax(beta), c=_jax(c))
    t = [_torch(x, precision) for x in (a, b, c, alpha, beta)]
    got = tgemm.matmul(t[0], t[1], backend="pallas", alpha=t[3], beta=t[4],
                       c=t[2])
    want = _torch([np.asarray(l) for l in jmp.limbs(want)], precision)
    assert max_rel_err(got, want) <= 16 * 9 * ULP[precision]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("precision", ["dd", "td", "qd"])
def test_ref_batched_equals_reference_oracle_loop(precision, layout):
    a, b = _cell(layout, precision)[:2]
    got = tgemm.matmul(_torch(a, precision), _torch(b, precision),
                       backend="ref")
    ja, jb = _jax(a), _jax(b)
    for i in range(3):
        ai = ja[i] if len(ja.shape) == 3 else ja
        bi = jb[i] if len(jb.shape) == 3 else jb
        want = _torch([np.asarray(l) for l in
                       jmp.limbs(jref.mlgemm_ref(ai, bi))], precision)
        assert _bitwise(got[i], want), i


def test_shared_operand_reaches_the_kernel_unbatched(monkeypatch):
    # an operand without batch dims is handed to the kernel as it is (the
    # kernel reads it with batch stride 0), never broadcast into a copy
    from repro_torch.kernels import mlgemm

    seen = []
    real = mlgemm.mlgemm_kernel_call

    def spy(*limbs):
        seen.append([tuple(l.shape) for l in limbs])
        return real(*limbs)

    monkeypatch.setattr(mlgemm, "mlgemm_kernel_call", spy)
    a, b = _cell("b", "td")[:2]
    tgemm.matmul(_torch(a, "td"), _torch(b, "td"), backend="pallas")
    assert seen == [[(7, 9)] * 3 + [(3, 9, 5)] * 3]


def test_batched_plan_and_errors():
    plan = tgemm.make_plan(7, 9, 5, backend="pallas", platform="cpu",
                           batch_shape=(2, 3))
    assert (plan.batch, plan.batch_shape) == ("vmap", (2, 3))
    a = _torch(_limbs((2, 3, 7, 9), "dd", 6), "dd")
    b = _torch(_limbs((9, 5), "dd", 7), "dd")
    out = tgemm.execute(plan, a, b)
    assert out.shape == (2, 3, 7, 5)
    assert _bitwise(out[1, 2], tgemm.matmul(a[1, 2], b, backend="pallas"))
    flat = tgemm.make_plan(7, 9, 5, backend="pallas", platform="cpu")
    with pytest.raises(ValueError, match="batch_shape"):
        tgemm.execute(flat, a, b)


def test_rgesv_batched_rhs_follows_reference():
    # refine's _cols/_uncols: a (2, n, 2) stack of right-hand sides, one
    # batched residual per iteration, corrections on all four columns
    n = 24
    rng = np.random.default_rng(13)
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    b = np.einsum("ij,bjk->bik", a, rng.standard_normal((2, n, 2)))
    kw = dict(factor_tier="f64", target_tier="dd", max_iters=10)
    x, info = rgesv(a, b, backend="xla", device="cpu", **kw)
    jx, jinfo = jrgesv(a, b, backend="xla", use_cache=False, **kw)
    assert x.shape == (2, n, 2)
    assert info.converged and jinfo.converged
    assert info.iterations == jinfo.iterations
    assert info.factorizations == jinfo.factorizations == {"f64": 1}
    want = _torch([np.asarray(l) for l in jmp.limbs(jx)], "dd")
    assert max_rel_err(x, want) <= 1e-28
    for got, ref in zip(info.backward_errors, jinfo.backward_errors):
        assert ref / 4 <= got <= ref * 4
