"""The port's per-op arithmetic against the JAX reference, bit for bit.

Same numpy inputs, made from a seed, go through ``repro`` and
``repro_torch`` (on the CPU).  Every comparison is exact (equal bit
patterns of every limb): the port runs the reference's op sequences, and
eager (un-jitted) JAX calls and eager torch both round each op on its own,
with no FMA contraction on either side.  (The jitted JAX engine does
contract; tests/test_torch_gemm.py holds that path to a ULP bound.)

XLA:CPU flushes subnormal results to zero, torch does not, so these tests
run the port with ``torch.set_flush_denormal(True)``: the two then round
the same way where an error limb lands below 2^-1022 (the (2^-1000, 1)
extreme-scale pair below).  Operands stay under torch's intra-op
parallelism threshold, so every op runs on the thread whose flag is set.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dd as jdd
from repro.core import efts as jefts
from repro.core import mp as jmp
from repro_torch.core import dd as tdd
from repro_torch.core import efts as tefts
from repro_torch.core import mp as tmp
from repro_torch.interop import limbs_from_numpy, limbs_to_numpy

pytestmark = pytest.mark.torch_port

N = 512


@pytest.fixture(autouse=True, scope="module")
def _ftz_single_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


def _bits(x):
    return np.asarray(x, np.float64).view(np.int64)


def _assert_bitwise(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        diff = np.flatnonzero(_bits(g) != _bits(w))
        assert diff.size == 0, (
            f"limb {i}: {diff.size} of {g.size} differ, first at "
            f"{diff[0]}: port {g.flat[diff[0]]!r} vs jax {w.flat[diff[0]]!r}")


def _wide(rng, shape, lo=-60, hi=60):
    """Normal f64 values over a wide band of exponents."""
    return rng.standard_normal(shape) * 2.0 ** rng.integers(lo, hi, shape)


def _tier(rng, precision, shape):
    """Random tier value (numpy limbs) with signal in every limb."""
    k = tmp.PRECISIONS[precision]
    x = tmp.from_float(torch.as_tensor(_wide(rng, shape, -8, 8)), precision)
    for i in range(1, k):
        extra = tmp.from_float(torch.as_tensor(
            rng.standard_normal(shape) * 2.0 ** (-53 * i)), precision)
        x = tmp.add(x, extra)
    return limbs_to_numpy(x)


def _both(limbs, precision):
    j = jmp.from_limbs([jnp.asarray(l) for l in limbs])
    t = limbs_from_numpy(limbs, precision, device="cpu")
    return j, t


@pytest.mark.parametrize("name", ["two_sum", "quick_two_sum", "two_prod",
                                  "two_prod_terms", "two_prod_exact"])
def test_efts_bitwise(name):
    rng = np.random.default_rng(1)
    # exponents out to +-700 reach both directions of the pow2 rescue
    a, b = _wide(rng, N, -700, 700), _wide(rng, N, -300, 300)
    if name == "quick_two_sum":  # precondition |a| >= |b|
        a, b = np.maximum(abs(a), abs(b)) * np.sign(a), \
            np.minimum(abs(a), abs(b))
    want = getattr(jefts, name)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(tefts, name)(torch.as_tensor(a), torch.as_tensor(b))
    _assert_bitwise(got, want)


def test_mask_split_bitwise():
    x = _wide(np.random.default_rng(2), N, -1000, 1000)
    _assert_bitwise(tefts.mask_split(torch.as_tensor(x)),
                    jefts.mask_split(jnp.asarray(x)))


# the extreme-scale pairs of tests/test_guard.py (TestExtremeScaleExactness):
# band-crossing rescues, including the (2^1020, 2^-485) _unscale regression
@pytest.mark.parametrize("ea,eb", [(1005, -1005), (1000, -1000), (-1000, 0),
                                   (990, -990), (1020, -485), (-485, 1020)])
def test_dd_mul_extreme_scales_bitwise(ea, eb):
    rng = np.random.default_rng(11)
    av = (rng.random(64) + 0.5) * 2.0 ** ea
    bv = (rng.random(64) + 0.5) * 2.0 ** eb
    want = jdd.mul(jdd.from_float(jnp.asarray(av)),
                   jdd.from_float(jnp.asarray(bv)))
    got = tdd.mul(tdd.from_float(av, device="cpu"),
                  tdd.from_float(bv, device="cpu"))
    _assert_bitwise(got, want)


DD_BINARY = ["add", "sub", "mul", "div"]


@pytest.mark.parametrize("op", DD_BINARY + ["sqrt", "add_float", "mul_float",
                                            "fma", "sum_", "dot"])
def test_dd_ops_bitwise(op):
    rng = np.random.default_rng(3)
    (ja, ta), (jb, tb), (jc, tc) = [_both(_tier(rng, "dd", (N,)), "dd")
                                    for _ in range(3)]
    if op in DD_BINARY:
        got, want = getattr(tdd, op)(ta, tb), getattr(jdd, op)(ja, jb)
    elif op == "sqrt":
        got, want = tdd.sqrt(tdd.abs_(ta)), jdd.sqrt(jdd.abs_(ja))
    elif op in ("add_float", "mul_float"):
        got, want = getattr(tdd, op)(ta, tb.hi), getattr(jdd, op)(ja, jb.hi)
    elif op == "fma":
        got, want = tdd.fma(tc, ta, tb), jdd.fma(jc, ja, jb)
    elif op == "sum_":
        # an odd length exercises the halving tree's tail fold
        got = tdd.sum_(ta[:N - 1].reshape(-1, 7), axis=0)
        want = jdd.sum_(ja[:N - 1].reshape(-1, 7), axis=0)
    else:
        got, want = tdd.dot(ta, tb), jdd.dot(ja, jb)
    _assert_bitwise(got, want)


@pytest.mark.parametrize("precision", ["dd", "td", "qd"])
@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "sqrt", "fma",
                                "sum_", "promote"])
def test_mp_ops_bitwise(precision, op):
    rng = np.random.default_rng(4)
    (ja, ta), (jb, tb), (jc, tc) = [_both(_tier(rng, precision, (96,)),
                                          precision) for _ in range(3)]
    if op in ("add", "sub", "mul", "div"):
        got, want = getattr(tmp, op)(ta, tb), getattr(jmp, op)(ja, jb)
    elif op == "sqrt":
        got, want = tmp.sqrt(tmp.abs_(ta)), jmp.sqrt(jmp.abs_(ja))
    elif op == "fma":
        got, want = tmp.fma(tc, ta, tb), jmp.fma(jc, ja, jb)
    elif op == "sum_":
        got = tmp.sum_(ta[:91].reshape(13, 7), axis=0)
        want = jmp.sum_(ja[:91].reshape(13, 7), axis=0)
    else:  # descend to dd and climb to qd
        got = [*tmp.limbs(tmp.promote(ta, "dd")),
               *tmp.limbs(tmp.promote(ta, "qd"))]
        want = [*jmp.limbs(jmp.promote(ja, "dd")),
                *jmp.limbs(jmp.promote(ja, "qd"))]
    _assert_bitwise(got, want)


def test_mixed_tiers_raise_and_counts_dispatch():
    rng = np.random.default_rng(5)
    a = limbs_from_numpy(_tier(rng, "td", (4,)), "td", device="cpu")
    b = limbs_from_numpy(_tier(rng, "qd", (4,)), "qd", device="cpu")
    with pytest.raises(TypeError, match="mixed precision tiers"):
        tmp.add(a, b)
    assert [tmp.precision_for_count(k) for k in (2, 3, 4)] == \
        ["dd", "td", "qd"]
    with pytest.raises(ValueError):
        tmp.precision_for_count(5)
    assert tmp.PRECISIONS == jmp.PRECISIONS
