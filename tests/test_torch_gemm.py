"""The port's GEMM engine against the JAX reference, backend by backend.

Same numpy limbs, made from a seed, go through ``repro.gemm`` and
``repro_torch.gemm`` (on the CPU) under the same plan: the reference's
plan crosses over with ``plan_from_dict``, so both run the same backend,
blocks and solved ``(slice_beta, n_slices)``.  On the CPU the port's
``pallas`` and ``ozaki-pallas`` backends run their kernels' plain
versions; the kernels themselves are held to those by ``chip_smoke.py``
on the card.

Tolerances:
  * ``16 * k * 2^-104`` in ``max_rel_err`` (tests/test_conformance.py's
    dd bound), wherever a multiply feeds an add: the reference's engine is
    jitted, and XLA:CPU contracts ``a*b + c`` into an FMA inside dd.mul
    (efts.py's docstring), which moves the low limb by a few ulp of the
    tier, while the port rounds every op on its own;
  * bit-for-bit equality for ``ozaki`` and ``ozaki-pallas`` with epilogue
    ``none``: their only multiplies are exact slice products, every
    diagonal sum is exact by the slice_params headroom, and the folds are
    adds, so neither FMA contraction nor summation order can move a bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import gemm as jgemm
from repro.core import mp as jmp
from repro.kernels import ozgemm as jozgemm
from repro.kernels import ref as jref
from repro_torch import gemm as tgemm
from repro_torch.core import dd as tdd
from repro_torch.core import mp as tmp
from repro_torch.core.accuracy import max_rel_err
from repro_torch.core.blas import rgemm
from repro_torch.gemm.engine import _apply_epilogue
from repro_torch.interop import limbs_from_numpy, limbs_to_numpy, \
    plan_from_dict
from repro_torch.kernels.ozgemm import ozgemm_kernel_call, ozgemm_plain

pytestmark = pytest.mark.torch_port

ULP = 2.0 ** -104
SHAPES = [(16, 16, 16), (13, 7, 9), (8, 33, 12)]  # test_conformance.py:56
EPILOGUES = ["none", "alpha", "full"]


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
def _limbs(shape, seed):
    """Random dd limbs with signal in the low limb (numpy, read-only)."""
    rng = np.random.default_rng(seed)
    hi = torch.as_tensor(rng.standard_normal(shape))
    lo = torch.as_tensor(rng.standard_normal(shape) * 2.0 ** -53)
    out = limbs_to_numpy(tdd.from_hi_lo(hi, lo))
    for l in out:
        l.setflags(write=False)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _scalars():
    """alpha = 1/3 and beta = -1/7 as dd limbs (non-representable)."""
    one = tdd.from_float(np.ones(()), device="cpu")
    third = tdd.div(one, tdd.from_float(np.full((), 3.0), device="cpu"))
    m7 = tdd.div(tdd.neg(one), tdd.from_float(np.full((), 7.0),
                                              device="cpu"))
    return tuple(limbs_to_numpy(third)), tuple(limbs_to_numpy(m7))


def _operands(m, k, n, epilogue):
    """(names -> numpy limbs) for one cell."""
    ops = {"a": _limbs((m, k), m * 31 + k), "b": _limbs((k, n), n * 17 + k)}
    third, m7 = _scalars()
    if epilogue != "none":
        ops["alpha"] = third
    if epilogue == "full":
        ops["beta"] = m7
        ops["c"] = _limbs((m, n), m + n)
    return ops


def _jax(ops):
    return {k: jmp.from_limbs([jnp.asarray(l) for l in v])
            for k, v in ops.items()}


def _torch(ops):
    return {k: limbs_from_numpy(v, "dd", device="cpu")
            for k, v in ops.items()}


def _run_both(backend, m, k, n, epilogue):
    ops = _operands(m, k, n, epilogue)
    jplan = jgemm.make_plan(m, k, n, backend=backend, use_cache=False)
    tplan = plan_from_dict(dataclasses.asdict(jplan))
    j, t = _jax(ops), _torch(ops)
    want = jgemm.execute(jplan, **j)
    got = tgemm.execute(tplan, **t)
    return got, limbs_from_numpy(limbs_to_numpy_jax(want), "dd", "cpu")


def limbs_to_numpy_jax(x):
    return [np.asarray(l) for l in jmp.limbs(x)]


def _bitwise(got, want):
    return all(torch.equal(g, w) for g, w in zip(tmp.limbs(got),
                                                 tmp.limbs(want)))


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("backend", ["ref", "xla", "ozaki"])
def test_backend_matches_reference_plan(backend, m, k, n, epilogue):
    got, want = _run_both(backend, m, k, n, epilogue)
    assert got.shape == (m, n)
    assert max_rel_err(got, want) <= 16 * k * ULP
    if backend == "ozaki" and epilogue == "none":
        assert _bitwise(got, want)


@functools.lru_cache(maxsize=None)
def _jax_oracle(m, k, n, epilogue):
    """The reference's ``ref`` backend on the cell (limbs, cached)."""
    ops = _jax(_operands(m, k, n, epilogue))
    return tuple(limbs_to_numpy_jax(jgemm.matmul(
        ops.pop("a"), ops.pop("b"), backend="ref", use_cache=False, **ops)))


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("backend", ["pallas", "ozaki-pallas"])
def test_kernel_plain_matches_reference_oracle(backend, m, k, n, epilogue):
    # the kernels' plain versions on the conformance shapes, against the
    # reference's O(mkn) oracle (interpret mode is run once per kernel,
    # below: it is slow)
    t = _torch(_operands(m, k, n, epilogue))
    got = tgemm.matmul(t.pop("a"), t.pop("b"), backend=backend, **t)
    want = limbs_from_numpy(_jax_oracle(m, k, n, epilogue), "dd", "cpu")
    assert max_rel_err(got, want) <= 16 * k * ULP


@pytest.mark.parametrize("epilogue", ["none", "full"])
@pytest.mark.parametrize("backend", ["pallas", "ozaki-pallas"])
def test_kernel_plain_matches_interpret_kernel(backend, epilogue):
    # the reference's Pallas kernel in interpret mode, through its engine,
    # as the reference's own tests run it; ragged (13, 7, 9) pads there
    got, want = _run_both(backend, 13, 7, 9, epilogue)
    assert max_rel_err(got, want) <= 16 * 7 * ULP
    if backend == "ozaki-pallas" and epilogue == "none":
        assert _bitwise(got, want)


@pytest.mark.parametrize("backend", ["ref", "xla", "ozaki", "pallas",
                                     "ozaki-pallas"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plan_matches_reference_planner(backend, m, k, n):
    jplan = jgemm.make_plan(m, k, n, backend=backend, use_cache=False)
    tplan = tgemm.make_plan(m, k, n, backend=backend, platform="cpu")
    keep = ("backend", "bm", "bn", "bk", "limb_dtype", "precision",
            "slice_dtype", "acc_dtype", "n_slices", "slice_beta",
            "target_bits", "full")
    assert {f: getattr(tplan, f) for f in keep} == \
        {f: getattr(jplan, f) for f in keep}


@pytest.mark.parametrize("backend", ["ref", "xla", "ozaki", "pallas",
                                     "ozaki-pallas"])
def test_beta_zero_never_reads_c(backend):
    # BLAS: beta == 0 means C is not read, so NaN/Inf in C cannot leak
    t = _torch(_operands(9, 11, 6, "full"))
    nan_c = tmp.map_limbs(lambda l: torch.full_like(l, float("nan")), t["c"])
    plain = tgemm.matmul(t["a"], t["b"], backend=backend, alpha=t["alpha"])
    for zero in (0.0, tdd.from_float(np.zeros(()), device="cpu")):
        got = tgemm.matmul(t["a"], t["b"], backend=backend,
                           alpha=t["alpha"], beta=zero, c=nan_c)
        assert _bitwise(got, plain)


def test_kernel_drain_selects_zero_for_zero_beta():
    # the in-drain guard of kernel #2 (and the post-step epilogue it
    # shares): a zero beta that reaches it selects 0 instead of 0 * NaN
    t = _torch(_operands(9, 11, 6, "full"))
    nan = [torch.full((9, 6), float("nan"), dtype=torch.float64)] * 2
    zero = [torch.zeros((1, 1), dtype=torch.float64)] * 2
    out = ozgemm_kernel_call(*tmp.limbs(t["a"]), *tmp.limbs(t["b"]),
                             *[l.reshape(1, 1) for l in tmp.limbs(t["alpha"])],
                             *zero, *nan, bk=8, beta=21, n_slices=6,
                             epilogue="full")
    assert all(bool(torch.isfinite(l).all()) for l in out)
    post = _apply_epilogue(t["a"][:, :6], t["alpha"],
                           tdd.DD(*[z.reshape(()) for z in zero]),
                           tdd.DD(*nan))
    assert all(bool(torch.isfinite(l).all()) for l in tmp.limbs(post))


@pytest.mark.parametrize("beta", [0.5, -1.0])
def test_beta_without_c_raises(beta):
    t = _torch(_operands(8, 8, 8, "none"))
    with pytest.raises(ValueError, match="without c="):
        tgemm.matmul(t["a"], t["b"], backend="xla", beta=beta)
    with pytest.raises(ValueError, match="without c="):
        rgemm("n", "n", 1.0, t["a"], t["b"], beta, backend="pallas")
    # beta == 0 without C is the BLAS no-op, not an error
    out = tgemm.matmul(t["a"], t["b"], backend="xla", beta=0.0)
    assert _bitwise(out, tgemm.matmul(t["a"], t["b"], backend="xla"))


def test_ozaki_has_no_qd_tier_and_tiers_do_not_mix():
    q = tmp.from_float(torch.ones(8, 8, dtype=torch.float64), "qd")
    with pytest.raises(ValueError, match="ozaki"):
        tgemm.matmul(q, q, backend="ozaki")
    d = tmp.from_float(torch.ones(8, 8, dtype=torch.float64), "dd")
    with pytest.raises(TypeError, match="tier"):
        tgemm.matmul(d, q, backend="xla")


TIER_ULP = {"td": 2.0 ** -155, "qd": 2.0 ** -205}  # test_conformance.py:43


@pytest.mark.parametrize("backend,precision", [
    ("pallas", "td"), ("pallas", "qd"), ("xla", "td"), ("xla", "qd"),
    ("ozaki", "td"), ("ref", "qd")])
def test_wider_tiers_match_reference_oracle(backend, precision):
    # td/qd run on the CPU through the same engine (kernel #1's plain
    # version is count-generic; its CUDA kernel is dd only so far)
    m, k, n = 7, 9, 5
    rng = np.random.default_rng(6)
    ops = []
    for shape in ((m, k), (k, n)):
        x = tmp.from_float(torch.as_tensor(rng.standard_normal(shape)),
                           precision)
        for i in range(1, tmp.PRECISIONS[precision]):
            x = tmp.add(x, tmp.from_float(torch.as_tensor(
                rng.standard_normal(shape) * 2.0 ** (-53 * i)), precision))
        ops.append(limbs_to_numpy(x))
    a, b = [limbs_from_numpy(l, precision, "cpu") for l in ops]
    ja, jb = [jmp.from_limbs([jnp.asarray(x) for x in l]) for l in ops]
    # the reference's oracle called eagerly (its jit at qd compiles for
    # tens of seconds); eager, it rounds op for op as the port does
    want = jref.mlgemm_ref(ja, jb)
    got = tgemm.matmul(a, b, backend=backend)
    assert tmp.precision_of(got) == precision
    want = limbs_from_numpy(limbs_to_numpy_jax(want), precision, "cpu")
    assert max_rel_err(got, want) <= 16 * k * TIER_ULP[precision]
    if backend == "ref":
        assert _bitwise(got, want)


def _tier_limbs(shape, precision, seed):
    """Normalized tier limbs with signal in every limb (numpy)."""
    rng = np.random.default_rng(seed)
    x = tmp.from_float(torch.as_tensor(rng.standard_normal(shape)),
                       precision)
    for i in range(1, tmp.PRECISIONS[precision]):
        x = tmp.add(x, tmp.from_float(torch.as_tensor(
            rng.standard_normal(shape) * 2.0 ** (-53 * i)), precision))
    return limbs_to_numpy(x)


def _tier_scalar(num, den, precision):
    """num / den as (1, 1) tier limbs (numpy)."""
    def one(v):
        return tmp.from_float(torch.full((1, 1), float(v),
                                         dtype=torch.float64), precision)
    return limbs_to_numpy(tmp.div(one(num), one(den)))


def _reference_ozgemm(a, b, alpha, beta_s, c, *, bk, beta, n_slices):
    """The reference kernel's body called eagerly: its ``_slab_update`` per
    K slab from a zero accumulator, then the drain's epilogue as written
    in ``repro/kernels/ozgemm.py``'s ``_ozgemm_kernel``."""
    m, k = a.shape
    n = b.shape[1]
    acc = jmp.zeros((m, n), jmp.precision_of(a))
    for k0 in range(0, k, bk):
        acc = jozgemm._slab_update(
            acc, jmp.map_limbs(lambda l: l[:, k0:k0 + bk], a),
            jmp.map_limbs(lambda l: l[k0:k0 + bk, :], b), beta=beta,
            n_slices=n_slices, slice_dtype="float64", acc_dtype="float64",
            full=False)
    res = acc
    if alpha is not None:
        res = jmp.mul(jmp.broadcast_to(alpha, res.shape), res)
    if c is not None:
        bc = jmp.mul(jmp.broadcast_to(beta_s, c.shape), c)
        bc = jmp.where(jnp.broadcast_to(jmp.is_zero(beta_s), bc.shape),
                       jmp.map_limbs(jnp.zeros_like, bc), bc)
        res = jmp.add(res, bc)
    return res


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("m,k,n", SHAPES[1:])
@pytest.mark.parametrize("precision", ["td", "qd"])
def test_ozgemm_plain_wider_tiers_match_reference_slab_update(
        precision, m, k, n, epilogue):
    # kernel #2's plain version at td/qd (the version the CUDA kernel is
    # held to on the card) against the reference's slab update and drain,
    # eagerly, under the reference's own plan: bit for bit, the order of
    # every rounding being the same
    jplan = jgemm.make_plan(m, k, n, precision=precision,
                            backend="ozaki-pallas", use_cache=False)
    tplan = tgemm.make_plan(m, k, n, precision=precision,
                            backend="ozaki-pallas", platform="cpu")
    assert (tplan.bk, tplan.slice_beta, tplan.n_slices) == \
        (jplan.bk, jplan.slice_beta, jplan.n_slices)
    ops = {"a": _tier_limbs((m, k), precision, 31),
           "b": _tier_limbs((k, n), precision, 32)}
    if epilogue != "none":
        ops["alpha"] = _tier_scalar(1, 3, precision)
    if epilogue == "full":
        ops["beta_s"] = _tier_scalar(-1, 7, precision)
        ops["c"] = _tier_limbs((m, n), precision, 33)
    t = {key: limbs_from_numpy(v, precision, "cpu")
         for key, v in ops.items()}
    j = {key: jmp.from_limbs([jnp.asarray(l) for l in v])
         for key, v in ops.items()}
    kw = dict(bk=jplan.bk, beta=jplan.slice_beta, n_slices=jplan.n_slices)
    with jax.disable_jit():
        want = _reference_ozgemm(j["a"], j["b"], j.get("alpha"),
                                 j.get("beta_s"), j.get("c"), **kw)
    got = ozgemm_plain(t["a"], t["b"], alpha=t.get("alpha"),
                       beta_s=t.get("beta_s"), c=t.get("c"), **kw)
    want = limbs_from_numpy(limbs_to_numpy_jax(want), precision, "cpu")
    assert _bitwise(got, want)
