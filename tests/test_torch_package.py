"""Package-level contracts of the PyTorch/CUDA port (``repro_torch``).

* it imports no JAX and nothing of ``repro``;
* entry points that make data default to the CUDA card and, without one,
  raise instead of carrying on quietly on the CPU;
* a kernel wrapper refuses what its CUDA kernel does not take, on the CPU
  too (it never falls back to a path the kernel lacks);
* a reference plan crosses over with its solved fields intact.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch
from repro import gemm as jgemm
from repro_torch import gemm as tgemm
from repro_torch.core import dd, mp
from repro_torch.interop import limbs_from_numpy, limbs_to_numpy, \
    plan_from_dict
from repro_torch.kernels.mlgemm import mlgemm_kernel_call
from repro_torch.kernels.ozgemm import ozgemm_kernel_call

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _hermetic(tmp_path):
    # both planners read their plan caches: never the user's files
    jgemm.set_default_cache(jgemm.PlanCache(str(tmp_path / "j.json")))
    tgemm.set_default_cache(tgemm.PlanCache(str(tmp_path / "t.json")))
    yield
    jgemm.set_default_cache(None)
    tgemm.set_default_cache(None)


def test_imports_no_jax_and_no_reference():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print(len(names))
    """)
    src = os.path.dirname(os.path.dirname(repro_torch.__file__))
    env = {**os.environ, "PYTHONPATH": src}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module was imported


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-CUDA error path "
                    "cannot show here")


@pytest.mark.parametrize("entry", ["from_float", "zeros", "identity",
                                   "hilbert_tier", "rgesv", "make_plan",
                                   "limbs_from_numpy"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry):
    _no_cuda()
    from repro_torch.core.accuracy import hilbert_tier
    from repro_torch.core.blas import identity
    from repro_torch.gemm import make_plan
    from repro_torch.solve import rgesv

    calls = {
        "from_float": lambda: dd.from_float(np.ones(3)),
        "zeros": lambda: mp.zeros((2, 2), "dd"),
        "identity": lambda: identity(3),
        "hilbert_tier": lambda: hilbert_tier("dd", 4),
        "rgesv": lambda: rgesv(np.eye(4), np.ones(4)),
        "make_plan": lambda: make_plan(8, 8, 8),
        "limbs_from_numpy": lambda: limbs_from_numpy([np.ones(2)] * 2, "dd"),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def _dd_limbs(shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(shape)),
            torch.as_tensor(rng.standard_normal(shape) * 2.0 ** -53)]


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    a, b = _dd_limbs((8, 8), 0), _dd_limbs((8, 8), 1)
    # a (slice, accumulator) pair no plan of the reference makes (its
    # slice_bits has no bf16 accumulator), and a slice count whose slices
    # do not fit a Hopper block's shared memory
    with pytest.raises(ValueError, match="bfloat16 with accumulator "
                                         "bfloat16"):
        ozgemm_kernel_call(*a, *b, bk=8, beta=4, n_slices=28,
                           slice_dtype_name="bfloat16",
                           acc_dtype_name="bfloat16")
    with pytest.raises(KeyError):
        jgemm.make_plan(8, 8, 8, backend="ozaki-pallas", use_cache=False,
                        slice_dtype="bfloat16", acc_dtype="bfloat16")
    with pytest.raises(ValueError, match="asks 246784 B of shared memory"):
        ozgemm_kernel_call(*a, *b, bk=16, beta=7, n_slices=40,
                           slice_dtype_name="bfloat16",
                           acc_dtype_name="float32")
    # an unregistered limb count, and batch axes that do not agree
    five = [a[0], a[1], b[0], b[1], torch.zeros_like(a[0])]
    with pytest.raises(ValueError, match="do not fit"):
        ozgemm_kernel_call(*five, *five, bk=8, beta=21, n_slices=8)
    with pytest.raises(ValueError, match="batch"):
        ozgemm_kernel_call(*[t.expand(2, 8, 8).contiguous() for t in a],
                           *[t.expand(3, 8, 8).contiguous() for t in b],
                           bk=8, beta=21, n_slices=6)
    with pytest.raises(ValueError, match="shape"):
        mlgemm_kernel_call(*[t.expand(2, 8, 8).contiguous() for t in a],
                           *[t.expand(3, 8, 8).contiguous() for t in b])
    # operands the kernels cannot read: non-contiguous, f32, bad shapes
    with pytest.raises(ValueError, match="contiguous"):
        mlgemm_kernel_call(a[0].T, a[1].T, *b)
    with pytest.raises(ValueError, match="float64"):
        mlgemm_kernel_call(*[t.float() for t in a], *b)
    with pytest.raises(ValueError, match="shape"):
        mlgemm_kernel_call(*a, *_dd_limbs((5, 8), 2))
    with pytest.raises(ValueError, match="epilogue"):
        ozgemm_kernel_call(*a, *b, bk=8, beta=21, n_slices=6,
                           epilogue="bias")


def test_plan_from_dict_round_trips_solved_fields():
    for backend in ("ozaki-pallas", "ozaki", "pallas", "xla"):
        jplan = jgemm.make_plan(257, 1000, 96, backend=backend,
                                use_cache=False)
        d = dataclasses.asdict(jplan)
        tplan = plan_from_dict(d)
        for f in dataclasses.fields(tplan):
            assert getattr(tplan, f.name) == d[f.name], f.name
        assert (tplan.bk, tplan.slice_beta, tplan.n_slices) == \
            (jplan.bk, jplan.slice_beta, jplan.n_slices)
    with pytest.raises(ValueError, match="no counterpart"):
        plan_from_dict({**d, "bogus": 1})


def test_limbs_round_trip_and_not_ported_options_raise():
    ls = [np.arange(6.0).reshape(2, 3), np.full((2, 3), 2.0 ** -60)]
    x = limbs_from_numpy(ls, "dd", device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(limbs_to_numpy(x), ls))
    from repro_torch.gemm import make_plan

    for kw in ({"comm": "psum"}, {"k_stream": 64}, {"check": "finite"},
               {"shard_axis": "rows"}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            make_plan(8, 8, 8, platform="cpu", **kw)
    # batched execution is ported: batch_shape= plans a batch axis
    plan = make_plan(8, 8, 8, platform="cpu", batch_shape=(3,))
    assert (plan.batch, plan.batch_shape) == ("vmap", (3,))


@pytest.mark.parametrize("precision", ["dd", "td", "qd"])
def test_plain_versions_never_dispatch_to_a_kernel(precision, monkeypatch):
    # the kernels' plain versions run the tier module's arithmetic, so on
    # the card they are plain by construction: with mp's dispatch made to
    # see every tensor as a card tensor whose kernel raises, they still
    # run, and give what the dispatching ops give on the CPU
    from repro_torch.kernels import mlgemm, mpops, ozgemm

    rng = np.random.default_rng(5)

    def val(shape):
        return mp.from_float(torch.as_tensor(rng.standard_normal(shape)),
                             precision)

    a, b, c = val((5, 7)), val((7, 6)), val((5, 6))
    alpha, beta_s = val((1, 1)), val((1, 1))
    oz = dict(bk=4, beta=20, n_slices=6, alpha=alpha, beta_s=beta_s, c=c)
    want = [mlgemm.mlgemm_plain(a, b), ozgemm.ozgemm_plain(a, b, **oz),
            mpops.mpops_plain("div", a, a), mpops.sum_plain(a, axis=0)]

    def no_kernel(*args, **kw):
        raise AssertionError("a plain version reached a kernel")

    monkeypatch.setattr(mp, "_kernel", lambda x: True)
    monkeypatch.setattr(mp, "_mpops", no_kernel)
    monkeypatch.setattr(mpops, "sum_", no_kernel)
    got = [mlgemm.mlgemm_plain(a, b), ozgemm.ozgemm_plain(a, b, **oz),
           mpops.mpops_plain("div", a, a), mpops.sum_plain(a, axis=0)]
    for g, w in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(mp.limbs(g),
                                                     mp.limbs(w)))
    with pytest.raises(AssertionError, match="reached a kernel"):
        mp.mul(a, a)
