"""Kernel #2's narrow-slice variant in the port, against the JAX reference.

The same numpy limbs, made from a seed, go through ``repro`` and
``repro_torch`` on the CPU.  The port's ``ozgemm_plain`` is the version
its CUDA kernel (``csrc/ozgemm_narrow.cu``) is held to on the card, bit for
bit, by ``chip_smoke.py``.

Tolerances:
  * bit for bit against the reference's slab update called eagerly
    (``jax.disable_jit()``): the narrow slices are exact, every pair
    product and every diagonal sum is exact in the accumulator by the
    slice_params headroom, the rescale multiplies by powers of two, and
    the folds and the drain round op for op as the reference's;
  * bit for bit against the reference's interpret-mode kernel under its
    jit with epilogue ``none``; XLA:CPU contracts FMAs inside ``mp.mul``
    (efts.py's docstring), which moves the epilogue's low limb, so the
    epilogues are held to ``16 * k * ulp(tier)`` there
    (tests/test_conformance.py's bound);
  * ``2^-90`` against the exact product where the reference's own tests
    set it for narrow plans (tests/test_ozgemm_kernel.py).
"""

import functools
import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import gemm as jgemm
from repro.core import mp as jmp
from repro.kernels import ozgemm as jozgemm
from repro.kernels.ref import ddgemm_ref
from repro_torch import gemm as tgemm
from repro_torch.core import mp as tmp
from repro_torch.core import ozaki as tozaki
from repro_torch.core.accuracy import max_rel_err
from repro_torch.interop import limbs_from_numpy, limbs_to_numpy
from repro_torch.kernels import ozslice
from repro_torch.kernels.ozgemm import (SLICE_PAIRS, f32_group,
                                        ozgemm_kernel_call, ozgemm_plain)

pytestmark = pytest.mark.torch_port

ULP = {"dd": 2.0 ** -104, "td": 2.0 ** -155, "qd": 2.0 ** -205}
NARROW = [("bfloat16", "float32"), ("float32", "float32"),
          ("bfloat16", "float64")]


@pytest.fixture(autouse=True)
def _hermetic(tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    jgemm.set_default_cache(jgemm.PlanCache(str(tmp_path / "j.json")))
    tgemm.set_default_cache(tgemm.PlanCache(str(tmp_path / "t.json")))
    yield
    jgemm.set_default_cache(None)
    tgemm.set_default_cache(None)
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _tier_limbs(shape, precision, seed, scale=1.0):
    """Normalized tier limbs with signal in every limb (numpy)."""
    rng = np.random.default_rng(seed)
    x = tmp.from_float(torch.as_tensor(rng.standard_normal(shape) * scale),
                       precision)
    for i in range(1, tmp.PRECISIONS[precision]):
        x = tmp.add(x, tmp.from_float(torch.as_tensor(
            rng.standard_normal(shape) * scale * 2.0 ** (-53 * i)),
            precision))
    return tuple(limbs_to_numpy(x))


@functools.lru_cache(maxsize=None)
def _tier_scalar(num, den, precision):
    def one(v):
        return tmp.from_float(torch.full((1, 1), float(v),
                                         dtype=torch.float64), precision)
    return tuple(limbs_to_numpy(tmp.div(one(num), one(den))))


def _j(limbs):
    return jmp.from_limbs([jnp.asarray(l) for l in limbs])


def _t(limbs, precision):
    return limbs_from_numpy(list(limbs), precision, "cpu")


def _bitwise(got, want):
    return all(torch.equal(g, w) for g, w in zip(tmp.limbs(got),
                                                 tmp.limbs(want)))


def _plan(m, k, n, precision, sdt, adt):
    jplan = jgemm.make_plan(m, k, n, precision=precision,
                            backend="ozaki-pallas", slice_dtype=sdt,
                            acc_dtype=adt, use_cache=False)
    return dict(bk=jplan.bk, beta=jplan.slice_beta, n_slices=jplan.n_slices)


@functools.lru_cache(maxsize=None)
def _reference_acc(precision, sdt, adt, m, k, n):
    """The reference kernel's slab updates, called eagerly from a zero
    accumulator (numpy limbs)."""
    kw = _plan(m, k, n, precision, sdt, adt)
    a = _j(_tier_limbs((m, k), precision, 41))
    b = _j(_tier_limbs((k, n), precision, 42))
    bk = kw.pop("bk")
    with jax.disable_jit():
        acc = jmp.zeros((m, n), precision)
        for k0 in range(0, k, bk):
            acc = jozgemm._slab_update(
                acc, jmp.map_limbs(lambda l: l[:, k0:k0 + bk], a),
                jmp.map_limbs(lambda l: l[k0:k0 + bk, :], b),
                slice_dtype=sdt, acc_dtype=adt, full=False, **kw)
    return tuple(np.asarray(l) for l in jmp.limbs(acc))


def _reference_drain(acc, alpha, beta_s, c):
    """The drain of ``repro/kernels/ozgemm.py``'s ``_ozgemm_kernel``."""
    res = acc
    if alpha is not None:
        res = jmp.mul(jmp.broadcast_to(alpha, res.shape), res)
    if c is not None:
        bc = jmp.mul(jmp.broadcast_to(beta_s, c.shape), c)
        bc = jmp.where(jnp.broadcast_to(jmp.is_zero(beta_s), bc.shape),
                       jmp.map_limbs(jnp.zeros_like, bc), bc)
        res = jmp.add(res, bc)
    return res


@pytest.mark.parametrize("epilogue", ["none", "alpha", "full"])
@pytest.mark.parametrize("m,k,n", [(13, 7, 9), (8, 33, 12)])
@pytest.mark.parametrize("sdt,adt", NARROW)
@pytest.mark.parametrize("precision", ["dd", "td", "qd"])
def test_plain_matches_reference_slab_update(precision, sdt, adt, m, k, n,
                                             epilogue):
    # ozgemm_plain's narrow branch against the reference's _slab_update
    # loop and drain, eagerly: the same rounding, op for op
    kw = _plan(m, k, n, precision, sdt, adt)
    tplan = tgemm.make_plan(m, k, n, precision=precision,
                            backend="ozaki-pallas", slice_dtype=sdt,
                            acc_dtype=adt, platform="cpu")
    assert (tplan.bk, tplan.slice_beta, tplan.n_slices) == \
        (kw["bk"], kw["beta"], kw["n_slices"])
    ops = {}
    if epilogue != "none":
        ops["alpha"] = _tier_scalar(1, 3, precision)
    if epilogue == "full":
        ops["beta_s"] = _tier_scalar(-1, 7, precision)
        ops["c"] = _tier_limbs((m, n), precision, 43)
    with jax.disable_jit():
        want = _reference_drain(
            _j(_reference_acc(precision, sdt, adt, m, k, n)),
            *(_j(ops[x]) if x in ops else None
              for x in ("alpha", "beta_s", "c")))
    got = ozgemm_plain(_t(_tier_limbs((m, k), precision, 41), precision),
                       _t(_tier_limbs((k, n), precision, 42), precision),
                       slice_dtype_name=sdt, acc_dtype_name=adt,
                       **{x: _t(v, precision) for x, v in ops.items()}, **kw)
    want = _t([np.asarray(l) for l in jmp.limbs(want)], precision)
    assert max_rel_err(got, want) <= 16 * k * ULP[precision]
    assert _bitwise(got, want)


@pytest.mark.parametrize("precision", ["dd", "qd"])
def test_f16_plain_matches_reference_slab_update(precision):
    # the f16/f32 pair (the f32/f32 kernel's code on the same f16-held
    # slices) against the reference's eager slab updates, epilogue full
    m, k, n = 8, 33, 12
    kw = _plan(m, k, n, precision, "float16", "float32")
    tplan = tgemm.make_plan(m, k, n, precision=precision,
                            backend="ozaki-pallas", slice_dtype="float16",
                            acc_dtype="float32", platform="cpu")
    assert (tplan.bk, tplan.slice_beta, tplan.n_slices) == \
        (kw["bk"], kw["beta"], kw["n_slices"])
    ops = {"alpha": _tier_scalar(1, 3, precision),
           "beta_s": _tier_scalar(-1, 7, precision),
           "c": _tier_limbs((m, n), precision, 43)}
    with jax.disable_jit():
        want = _reference_drain(
            _j(_reference_acc(precision, "float16", "float32", m, k, n)),
            *(_j(ops[x]) for x in ("alpha", "beta_s", "c")))
    got = ozgemm_plain(_t(_tier_limbs((m, k), precision, 41), precision),
                       _t(_tier_limbs((k, n), precision, 42), precision),
                       slice_dtype_name="float16", acc_dtype_name="float32",
                       **{x: _t(v, precision) for x, v in ops.items()}, **kw)
    assert _bitwise(got, _t([np.asarray(l) for l in jmp.limbs(want)],
                            precision))


def test_f16_workspace_is_the_f32_workspace():
    # f16/f32 launches the f32/f32 build (ozslice.CUDA_VARIANT): the two
    # pairs' plans agree and their workspaces hold the same f16 bits, an
    # f32/f32 slice being exact in f16
    x = _t(_tier_limbs((19, 37), "td", 61), "td")
    kw = _plan(19, 37, 23, "td", "float32", "float32")
    assert kw == _plan(19, 37, 23, "td", "float16", "float32")
    v16, v32 = SLICE_PAIRS["float16", "float32"], SLICE_PAIRS["float32",
                                                              "float32"]
    assert ozslice.CUDA_VARIANT[v16] == v32
    for rows in (True, False):
        w16 = ozslice.ozslice_plain(x, rows=rows, variant=v16, **kw)
        w32 = ozslice.ozslice_plain(x, rows=rows, variant=v32, **kw)
        assert w16[0].dtype == w32[0].dtype == torch.float16
        assert torch.equal(w16[0].view(torch.int16),
                           w32[0].view(torch.int16))
        assert torch.equal(w16[1], w32[1])


def test_f16_whole_k_ozaki_matches_reference():
    # the whole-K ozaki backend takes the pair too, on CPU tensors, with
    # the reference's bits
    a, b = _tier_limbs((13, 7), "dd", 81), _tier_limbs((7, 9), "dd", 82)
    kw = dict(backend="ozaki", slice_dtype="float16", acc_dtype="float32")
    want = jgemm.matmul(_j(a), _j(b), use_cache=False, **kw)
    got = tgemm.matmul(_t(a, "dd"), _t(b, "dd"), platform="cpu", **kw)
    assert _bitwise(got, _t([np.asarray(l) for l in jmp.limbs(want)], "dd"))


def _both_matmul(a_np, b_np, epilogue="none"):
    """The narrow plan through both engines' matmul (the reference's kernel
    in interpret mode, as its own tests run it)."""
    kw = dict(backend="ozaki-pallas", slice_dtype="bfloat16",
              acc_dtype="float32")
    ops = {}
    if epilogue == "full":
        m, n = a_np[0].shape[0], b_np[0].shape[1]
        ops = {"alpha": _tier_scalar(1, 3, "dd"),
               "beta": _tier_scalar(-1, 7, "dd"),
               "c": _tier_limbs((m, n), "dd", 44)}
    want = jgemm.matmul(_j(a_np), _j(b_np), use_cache=False, **kw,
                        **{x: _j(v) for x, v in ops.items()})
    got = tgemm.matmul(_t(a_np, "dd"), _t(b_np, "dd"), platform="cpu", **kw,
                       **{x: _t(v, "dd") for x, v in ops.items()})
    return got, _t([np.asarray(l) for l in jmp.limbs(want)], "dd"), \
        ddgemm_ref(_j(a_np), _j(b_np))


def _dd_np(x):
    return tuple(np.asarray(l) for l in (x.hi, x.lo))


@pytest.mark.parametrize("epilogue", ["none", "full"])
def test_bf16_slices_f32_acc_match_interpret_kernel(epilogue):
    # twin of tests/test_ozgemm_kernel.py::test_bf16_slices_f32_acc_on_
    # interpret: 12x16x10, the TPU kernel's own configuration
    a, b = _tier_limbs((12, 16), "dd", 8), _tier_limbs((16, 10), "dd", 9)
    got, want, exact = _both_matmul(a, b, epilogue)
    if epilogue == "none":
        assert _bitwise(got, want)
        assert max_rel_err(got, _t(_dd_np(exact), "dd")) < 2.0 ** -90
    assert max_rel_err(got, want) <= 16 * 16 * ULP["dd"]


def test_bf16_ladder_survives_tiny_rows():
    # twin of test_bf16_ladder_survives_tiny_rows: rows at 1e-30 and
    # columns at 1e25 normalize to O(1) slices, none underflows bf16
    rng = np.random.default_rng(12)
    a = (rng.standard_normal((8, 16)) * 1e-30, np.zeros((8, 16)))
    b = (rng.standard_normal((16, 8)) * 1e+25, np.zeros((16, 8)))
    got, want, exact = _both_matmul(a, b)
    assert _bitwise(got, want)
    assert max_rel_err(got, _t(_dd_np(exact), "dd")) < 2.0 ** -90


def test_all_positive_worst_case_is_exact():
    # twin of test_diagonal_grouping_is_exact_on_worst_case with the narrow
    # plan: all-positive operands maximize the grouped f32 sums
    rng = np.random.default_rng(11)
    a = (rng.random((16, 64)), np.zeros((16, 64)))
    b = (rng.random((64, 16)), np.zeros((64, 16)))
    got, want, exact = _both_matmul(a, b)
    assert _bitwise(got, want)
    assert max_rel_err(got, _t(_dd_np(exact), "dd")) < 16 * 64 * ULP["dd"]


def _headroom_operand(shape, beta, seed, nlimbs=2):
    """All-positive tier values in [1, 2) (limbs as numpy) whose every slice
    digit is 2^(beta-1) - 1 or one less: the largest all-positive digits
    that round-to-nearest slicing leaves (slice 0 sits on the grid
    2^(2-beta), below the anchor 2^1), so the diagonal sums come as near
    their headroom as slicing lets them."""
    rng = np.random.default_rng(seed)
    top = 2 ** (beta - 1) - 1
    n_digits = 1 + (53 * nlimbs - (beta - 1)) // beta  # what the limbs hold
    limbs = [np.empty(shape) for _ in range(nlimbs)]
    for idx in np.ndindex(*shape):
        v = sum(Fraction(top - int(rng.integers(0, 2)) * (i > 0),
                         2 ** (i * beta)) for i in range(n_digits))
        v *= Fraction(2 ** 2, 2 ** beta)
        for l in limbs:
            l[idx] = float(v)
            v -= Fraction(l[idx])
    return tuple(limbs)


def test_adversarial_headroom_sums_are_exact():
    # the f32 diagonal sums of the plain version on the worst digits equal
    # the same slice dots in f64, where they are exact: nothing was rounded
    kw = _plan(32, 16, 32, "dd", "bfloat16", "float32")
    assert (kw["bk"], kw["beta"], kw["n_slices"]) == (16, 8, 15)
    a = _t(_headroom_operand((32, 16), 8, 1), "dd")
    b = _t(_headroom_operand((16, 32), 8, 2), "dd")
    sa = tozaki._extract_slices(a, 8, 15, axis=-1)
    sb = tozaki._extract_slices(b, 8, 15, axis=-2)
    assert float(torch.max(sa[0])) * 2 ** 6 == 127  # the top digit
    sa, _ = tozaki._normalize_slices(sa, 8, -1, torch.bfloat16)
    sb, _ = tozaki._normalize_slices(sb, 8, -2, torch.bfloat16)
    top = 0.0
    for (d, f32), (_, f64) in zip(
            tozaki.diagonal_sums(sa, sb, 15, False, torch.float32),
            tozaki.diagonal_sums(sa, sb, 15, False, torch.float64)):
        assert torch.equal(f32.to(torch.float64), f64), d
        top = max(top, float(f64.abs().max()) * 2.0 ** 14)  # grid units
    assert 2 ** 21 < top < 2 ** 24
    # and the whole product through the narrow plan matches the exact one
    got = tgemm.matmul(a, b, backend="ozaki-pallas", slice_dtype="bfloat16",
                       acc_dtype="float32", platform="cpu")
    want = tgemm.matmul(a, b, backend="ref", platform="cpu")
    assert max_rel_err(got, want) <= 16 * 16 * ULP["dd"]


@pytest.mark.parametrize("bk", [16, 32, 64])
@pytest.mark.parametrize("precision", ["dd", "td", "qd"])
def test_bf16_f64_groups_in_kernel_order_are_exact(precision, bk):
    # bf16/f64: the kernel sums zero-C 16-deep MMA results in f32 groups of
    # f32_group(beta), closing a group when the next step of two pairs could
    # overfill it, and adds each group into the diagonal's f64 sum.  The
    # group, in pairs, is the largest the 24-bit rule allows; in the
    # kernel's order, on adversarial digits, every MMA result and every f32
    # partial sum is exact and the f64 sums are ozgemm_plain's, bit for bit
    nl = {"dd": 2, "td": 3, "qd": 4}[precision]
    plan = tgemm.make_plan(16, bk, 16, precision=precision,
                           backend="ozaki-pallas", bk=bk,
                           slice_dtype="bfloat16", acc_dtype="float64",
                           platform="cpu")
    beta, ns = plan.slice_beta, plan.n_slices
    assert plan.bk == bk and beta == 8
    cap = f32_group(beta)
    kp = ozslice.kdepth(bk, SLICE_PAIRS["bfloat16", "float64"])
    pairs = cap // (kp // 16)

    def rule(g):
        return 2 * beta + math.ceil(math.log2(bk)) + math.ceil(math.log2(g))

    assert rule(pairs) <= 24 < rule(2 * pairs)
    a = _t(_headroom_operand((16, bk), beta, 3, nl), precision)
    b = _t(_headroom_operand((bk, 16), beta, 4, nl), precision)
    sk = dict(bk=bk, beta=beta, n_slices=ns, variant=2)
    wa, _ = ozslice.ozslice_plain(a, rows=True, **sk)
    wb, _ = ozslice.ozslice_plain(b, rows=False, **sk)
    sa = [wa[0, 0, s, :16].double() for s in range(ns)]
    sb = [wb[0, 0, t, :16].double() for t in range(ns)]
    plain = tozaki.diagonal_sums(sa, [x.T for x in sb], ns, False,
                                 torch.float64)
    closes, top = 0, 0.0
    for d, want in plain:
        gs = torch.zeros(16, 16, dtype=torch.float32)
        tot = torch.zeros(16, 16, dtype=torch.float64)
        n = 0
        lo, hi = max(0, d - ns + 1), min(d, ns - 1)
        steps = [(s, s + 1) for s in range(lo, hi, 2) if s + 1 <= hi]
        steps += [(s,) for s in range(lo + 2 * len(steps), hi + 1)]
        for us in steps:
            for kb in range(0, kp, 16):
                for u in us:
                    r = sa[u][:, kb:kb + 16] @ sb[d - u][:, kb:kb + 16].T
                    assert torch.equal(r.float().double(), r)  # one MMA
                    gs = gs + r.float()
                n += len(us)
                if n + 2 > cap:
                    tot, gs, n = tot + gs.double(), gs * 0, 0
                    closes += 1
        if n:
            tot = tot + gs.double()
        assert torch.equal(tot, want), d
        top = max(top, float(want.abs().max()) * 2.0 ** (2 * beta))
    assert top < 2.0 ** 53
    if precision != "dd" and bk == 16:
        # diagonals of more than 16 pairs pass 2^24 grid units: one f32
        # group would not hold them, and the kernel closed groups early
        assert top > 2.0 ** 24 and closes > 0


@pytest.mark.parametrize("sdt", ["float32", "float16"])
def test_f32_accumulator_plans_keep_beta_within_f16(sdt):
    # the f32/f32 and f16/f32 kernels hold their slices as f16 (11 bits):
    # every plan the planner gives them has beta <= 11, at any depth,
    # coverage target or slice count
    for precision in ("dd", "td", "qd"):
        for bk in (1, 2, 4, 16, 64, 256):
            for extra in ({}, {"target_bits": 24}, {"n_slices": 1},
                          {"n_slices": 2}):
                plan = tgemm.make_plan(512, 512, 512, precision=precision,
                                       backend="ozaki-pallas", bk=bk,
                                       slice_dtype=sdt, acc_dtype="float32",
                                       platform="cpu", **extra)
                assert plan.slice_beta <= 11, (precision, bk, extra)
    for precision in ("dd", "td"):  # whole K (no qd tier)
        plan = tgemm.make_plan(8, 2, 8, precision=precision, backend="ozaki",
                               slice_dtype=sdt, acc_dtype="float32",
                               n_slices=1, platform="cpu")
        assert plan.slice_beta <= 11


@pytest.mark.parametrize("bk", [16, 32, 64])
@pytest.mark.parametrize("precision", ["dd", "td", "qd"])
def test_narrow_plans_match_reference_planner(precision, bk):
    for sdt, adt in [*NARROW, ("float16", "float32"), ("float32", "float64"),
                     ("bfloat16", None)]:
        jplan = jgemm.make_plan(256, 256, 256, precision=precision,
                                backend="ozaki-pallas", bk=bk,
                                slice_dtype=sdt, acc_dtype=adt,
                                use_cache=False)
        tplan = tgemm.make_plan(256, 256, 256, precision=precision,
                                backend="ozaki-pallas", bk=bk,
                                slice_dtype=sdt, acc_dtype=adt,
                                platform="cpu")
        keep = ("bk", "slice_beta", "n_slices", "slice_dtype", "acc_dtype",
                "target_bits")
        assert {f: getattr(tplan, f) for f in keep} == \
            {f: getattr(jplan, f) for f in keep}, (sdt, adt)


@pytest.mark.parametrize("sdt,adt", [*NARROW, ("float16", "float32"),
                                     ("float32", "float64")])
def test_batched_narrow_equals_looped(sdt, adt):
    a = _t(_tier_limbs((5, 20, 12), "td", 51), "td")
    b = _t(_tier_limbs((5, 12, 9), "td", 52), "td")
    kw = dict(backend="ozaki-pallas", slice_dtype=sdt, acc_dtype=adt,
              platform="cpu")
    got = tgemm.matmul(a, b, **kw)
    for i in range(5):
        assert _bitwise(got[i], tgemm.matmul(a[i], b[i], **kw))
    # the wrapper with B shared, at the plan's parameters
    plan = tgemm.make_plan(20, 12, 9, precision="td", **kw)
    out = ozgemm_kernel_call(*tmp.limbs(a), *tmp.limbs(b[0]), bk=plan.bk,
                             beta=plan.slice_beta, n_slices=plan.n_slices,
                             slice_dtype_name=sdt, acc_dtype_name=adt)
    for i in range(5):
        assert _bitwise(tmp.from_limbs([l[i] for l in out]),
                        tgemm.matmul(a[i], b[0], **kw))


def test_every_plan_pair_is_a_kernel_pair():
    # what make_plan can hand the kernel with narrow overrides is accepted
    for sdt, adt in [*NARROW, ("float16", "float32"), ("float32", None),
                     ("bfloat16", None)]:
        plan = tgemm.make_plan(8, 8, 8, backend="ozaki-pallas",
                               slice_dtype=sdt, acc_dtype=adt,
                               platform="cpu")
        assert (plan.slice_dtype, plan.acc_dtype or "float64") in SLICE_PAIRS


@pytest.mark.parametrize("sdt,adt", [("float16", None),
                                     ("float64", "float32")])
def test_pairs_the_kernel_still_refuses(sdt, adt):
    # the reference's planner plans these, the kernel refuses them: f16
    # slices with an f64 accumulator reach beta 22, past f16's 11 bits (the
    # reference's f16 slices are rounded), and f64/f32 is an f64 slice dot
    # typed to f32
    jplan = jgemm.make_plan(8, 8, 8, backend="ozaki-pallas", use_cache=False,
                            slice_dtype=sdt, acc_dtype=adt)
    plan = tgemm.make_plan(8, 8, 8, backend="ozaki-pallas", slice_dtype=sdt,
                           acc_dtype=adt, platform="cpu")
    assert (plan.slice_beta, plan.n_slices) == (jplan.slice_beta,
                                                jplan.n_slices)
    if sdt == "float16":
        assert plan.slice_beta > 11
    a = _t(_tier_limbs((8, 8), "dd", 91), "dd")
    with pytest.raises(ValueError, match="accumulator"):
        tgemm.matmul(a, a, backend="ozaki-pallas", slice_dtype=sdt,
                     acc_dtype=adt, platform="cpu")
