"""Kernel #2's slicing pre-pass and the GEMM on its workspace, in the port.

The same numpy limbs, made from a seed, go through ``repro`` and
``repro_torch`` on the CPU.  ``ozslice_plain`` and ``ozgemm_plain`` are
the versions the CUDA kernels (``csrc/ozslice.cu``, ``csrc/ozgemm.cu``,
``csrc/ozgemm_narrow.cu``) are held to on the card, bit for bit, by
``chip_smoke.py``.

Tolerances: none.  The pre-pass repeats the reference's slicing op for op
(eagerly, ``jax.disable_jit()``), so its slices and scales are the
reference's bits; the GEMM's pair products and diagonal sums are exact, so
the product equals the reference's interpret-mode kernel bit for bit with
epilogue ``none`` (with an epilogue, XLA:CPU's contracted FMAs move the
reference's low limb; tests/test_torch_ozgemm_narrow.py holds that case).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import gemm as jgemm
from repro.core import mp as jmp
from repro.core import ozaki as jozaki
from repro.kernels import ozgemm as jozgemm
from repro_torch import gemm as tgemm
from repro_torch.core import mp as tmp
from repro_torch.interop import limbs_from_numpy, limbs_to_numpy
from repro_torch.kernels import _build, ozgemm, ozslice

pytestmark = pytest.mark.torch_port

PAIRS = [("float64", "float64"), ("bfloat16", "float32"),
         ("float32", "float32")]


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


def _operand(shape, precision):
    """Random tier limbs with a zero row, a NaN row, tiny rows (x 2^-100)
    and huge columns (x 2^83), as in tests/test_ozgemm_kernel.py's tiny-rows
    operands (rows and columns of A, or of B)."""
    limbs = [l.copy() for l in _tier_limbs(shape, precision, 51)]
    for l in limbs:
        l[2, :] = 0.0
        l[:, 2] = 0.0
        l[9:12, :] *= 2.0 ** -100
        l[:, 5:7] *= 2.0 ** 83
    limbs[0][5, 7] = np.nan
    return limbs


def _plan(m, k, n, precision, sdt, adt):
    jplan = jgemm.make_plan(m, k, n, precision=precision,
                            backend="ozaki-pallas", slice_dtype=sdt,
                            acc_dtype=adt, use_cache=False)
    return dict(bk=jplan.bk, beta=jplan.slice_beta, n_slices=jplan.n_slices)


def _same(got, want):
    """Bitwise, NaN payloads included."""
    return got.shape == want.shape and np.array_equal(
        np.ascontiguousarray(got).view(np.uint8),
        np.ascontiguousarray(want).view(np.uint8))


@pytest.mark.parametrize("sdt,adt", PAIRS)
@pytest.mark.parametrize("precision", ["dd", "td", "qd"])
def test_prepass_matches_reference_slices(precision, sdt, adt):
    # the plain pre-pass against the reference's _extract_slices and
    # _normalize_slices, slab by slab: A 13 x 37 (ragged: three slabs, the
    # last 5 deep) and B 37 x 9, bit for bit, the workspace's padding zero
    m, k, n = 13, 37, 9
    kw = _plan(m, k, n, precision, sdt, adt)
    bk, beta, ns = kw["bk"], kw["beta"], kw["n_slices"]
    nslab = -(-k // bk)
    variant = ozgemm.SLICE_PAIRS[sdt, adt]
    a_l, b_l = _operand((m, k), precision), _operand((k, n), precision)

    def slab_rows(l):  # (r, k) -> (r * nslab, bk), zero-padded as the
        return np.pad(l, ((0, 0), (0, -k % bk))).reshape(-1, bk)  # reference

    # one reference call slices every slab of every row of A and column of
    # B, each a row of its own
    cut = [np.concatenate([slab_rows(la), slab_rows(lb.T)])
           for la, lb in zip(a_l, b_l)]
    with jax.disable_jit():
        want = jozaki._extract_slices(
            jmp.from_limbs([jnp.asarray(l) for l in cut]), beta, ns, axis=1)
        if variant is not None:
            want, want_sc = jozaki._normalize_slices(want, beta, 1, sdt)
    for rows, limbs, r, off in ((True, a_l, m, 0), (False, b_l, n, m * nslab)):
        ws, sc = ozslice.ozslice_plain(
            limbs_from_numpy(limbs, precision, "cpu"), rows=rows,
            variant=variant, **kw)
        assert ws.shape == (1, nslab, ns, 64, 16)
        assert ws.dtype == ozslice.STORAGE[variant]
        own = slice(off, off + r * nslab)
        if variant is not None:
            assert _same(sc[0, :, :r].numpy(),
                         np.asarray(want_sc)[own, 0].reshape(r, nslab).T)
        ws = ws.to(torch.float64).numpy()
        for s, w in enumerate(want):
            w = np.asarray(w.astype(jnp.float64))[own]
            assert _same(ws[0, :, s, :r, :bk],
                         w.reshape(r, nslab, bk).transpose(1, 0, 2)), (rows, s)
        assert not np.any(ws[:, :, :, r:]) and not np.any(ws[..., bk:])


@pytest.mark.parametrize("precision,k", [("dd", 32), ("td", 16), ("qd", 16)])
def test_plain_on_workspace_matches_interpret_kernel(precision, k):
    # the reference's kernel in interpret mode, as its own tests run it,
    # on one 8x8 output block (block-multiple shapes, as it takes)
    a, b = _tier_limbs((8, k), precision, 61), _tier_limbs((k, 8), precision,
                                                           62)
    kw = _plan(8, k, 8, precision, "float64", "float64")
    want = jozgemm.ozgemm_kernel_call(
        *[jnp.asarray(l) for l in a], *[jnp.asarray(l) for l in b], bm=8,
        bn=8, slice_dtype_name="float64", acc_dtype_name="float64", **kw)
    got = ozgemm.ozgemm_plain(limbs_from_numpy(a, precision, "cpu"),
                              limbs_from_numpy(b, precision, "cpu"), **kw)
    assert all(_same(g.numpy(), np.asarray(w))
               for g, w in zip(tmp.limbs(got), want))


@pytest.mark.parametrize("sdt,adt", [("float64", "float64"),
                                     ("bfloat16", "float32")])
def test_k_panels_equal_one_panel(sdt, adt):
    # a budget of one byte walks K one slab per panel, carrying the
    # accumulator; the epilogue applies once: the bits of one panel
    m, k, n = 10, 45, 8
    kw = _plan(m, k, n, "dd", sdt, adt)

    def val(shape, seed):
        return limbs_from_numpy(_tier_limbs(shape, "dd", seed), "dd", "cpu")

    a, b, c = val((3, m, k), 71), val((k, n), 72), val((3, m, n), 73)
    ep = dict(alpha=val((1, 1), 74), beta_s=val((1, 1), 75), c=c)
    one = ozgemm.ozgemm_plain(a, b, slice_dtype_name=sdt, acc_dtype_name=adt,
                              **ep, **kw)
    assert ozgemm.panel_slabs(3, 3, m, 1, n, kw["bk"], kw["n_slices"],
                              ozgemm.SLICE_PAIRS[sdt, adt], 1) == 1
    panels = ozgemm.ozgemm_plain(a, b, slice_dtype_name=sdt,
                                 acc_dtype_name=adt, workspace_bytes=1,
                                 **ep, **kw)
    assert all(torch.equal(g, w) for g, w in zip(tmp.limbs(panels),
                                                 tmp.limbs(one)))


@pytest.mark.parametrize("bk,n_slices,sdt,adt,want", [
    # f64: 5 slices x 128 rows x (16 + 4) x 8 B a stage, two stages
    (16, 5, "float64", "float64", 2 * 5 * 128 * 20 * 8),
    # qd's 10 f64 slices: one stage of 204,800 B
    (16, 10, "float64", "float64", 10 * 128 * 20 * 8),
    # bf16 dd: 15 x 128 x (16 + 8) x 2 B and the 128 scales, two stages
    (16, 15, "bfloat16", "float32", 2 * (15 * 128 * 24 * 2 + 128 * 8)),
    # every variant runs two stages where two fit: f32/f32 and f16/f32
    # (f16-held slices) and bf16/f64 at dd's 15 slices, f32/f64 (4-byte
    # slices) at dd's 5 and td's 8
    (16, 15, "float32", "float32", 2 * (15 * 128 * 24 * 2 + 128 * 8)),
    (16, 15, "float16", "float32", 2 * (15 * 128 * 24 * 2 + 128 * 8)),
    (16, 15, "bfloat16", "float64", 2 * (15 * 128 * 24 * 2 + 128 * 8)),
    (16, 5, "float32", "float64", 2 * (5 * 128 * 24 * 4 + 128 * 8)),
    (16, 8, "float32", "float64", 2 * (8 * 128 * 24 * 4 + 128 * 8)),
    # one stage where two do not fit: bf16 td/qd, f32/f32 at qd's 32
    # slices, f32/f64 at qd's 10 and at depth 32
    (16, 24, "bfloat16", "float32", 24 * 128 * 24 * 2 + 128 * 8),
    (16, 32, "float32", "float32", 32 * 128 * 24 * 2 + 128 * 8),
    (16, 10, "float32", "float64", 10 * 128 * 24 * 4 + 128 * 8),
    (17, 8, "float32", "float64", 8 * 128 * 40 * 4 + 128 * 8),
])
def test_smem_bytes_is_the_stage_layout(bk, n_slices, sdt, adt, want):
    assert ozgemm.smem_bytes(bk, n_slices, sdt, adt) == want
    variant = ozgemm.SLICE_PAIRS[sdt, adt]
    shapes = ozslice.workspace_shapes(2, 3, n_slices, 70, bk, variant)
    assert shapes[0] == (2, 3, n_slices, 128, -(-bk // 16) * 16
                         if variant is not None else -(-bk // 4) * 4)
    assert shapes[1] == (None if variant is None else (2, 3, 128))


def test_failed_launches_raise(monkeypatch):
    # a launch that returns a CUDA error raises; nothing falls back to the
    # plain version
    def refuse(*args):
        return 1

    class Lib:
        ozslice = ozgemm_narrow = staticmethod(refuse)

    monkeypatch.setattr(_build, "load", lambda *a: Lib())
    monkeypatch.setattr(_build, "stream", lambda dev: None)
    a = [torch.ones(4, 8), torch.zeros(4, 8)]
    b = [torch.ones(8, 3), torch.zeros(8, 3)]
    out = (torch.empty(1, 1, 15, 64, 16, dtype=torch.bfloat16),
           torch.empty(1, 1, 64, dtype=torch.float64))
    with pytest.raises(RuntimeError, match="ozslice launch at 2 limbs"):
        ozslice._launch(a, True, 8, 8, 15, 0, 0, 1, out)
    monkeypatch.setattr(ozgemm, "ozslice_call", lambda *a, **k: out)
    with pytest.raises(RuntimeError, match="ozgemm launch at 2 limbs"):
        ozgemm._launch(2, a, b, None, None, None, None, bk=8, beta=8,
                       n_slices=15, n_diag=15, epi="none", variant=0)
