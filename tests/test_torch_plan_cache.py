"""The port's plan cache and autotuner, against the JAX reference's.

Twins of tests/test_gemm_engine.py's TestAutotuneCache and
tests/test_ozgemm_kernel.py's n_slices cases, run on the CPU (``platform=
"cpu"``, the kernels' plain versions).  Every test points the port's cache
at a temporary file: the port never reads or writes the user's cache here.
"""

import json

import numpy as np
import pytest
import torch

from repro import gemm as jgemm
from repro_torch import gemm
from repro_torch.gemm import cache as tcache
from repro_torch.kernels.ozgemm import SMEM_LIMIT, smem_bytes

pytestmark = pytest.mark.torch_port


@pytest.fixture()
def tmp_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_GEMM_CACHE", str(tmp_path / "env.json"))
    cache = gemm.PlanCache(str(tmp_path / "plans.json"))
    gemm.set_default_cache(cache)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield cache
    gemm.set_default_cache(None)
    torch.set_num_threads(threads)


def _plan(*mkn, **kw):
    return gemm.make_plan(*mkn, platform="cpu", **kw)


def test_cache_round_trip_on_disk(tmp_cache):
    key = gemm.cache_key("cpu", "float64", 100, 100, 100, "pallas")
    tmp_cache.put(key, {"bm": 32, "bn": 64, "bk": 8})
    reread = gemm.PlanCache(tmp_cache.path)  # fresh object: from disk
    assert reread.get(key) == {"bm": 32, "bn": 64, "bk": 8}
    with open(tmp_cache.path) as f:
        assert key in json.load(f)


def test_planner_uses_tuned_blocks_in_bucket(tmp_cache):
    key = gemm.cache_key("cpu", "float64", 100, 100, 100, "pallas")
    tmp_cache.put(key, {"bm": 32, "bn": 64, "bk": 8})
    for mkn in (100, 120):  # one 128-bucket
        plan = _plan(mkn, mkn, mkn, backend="pallas")
        assert plan.source == "tuned"
        assert (plan.bm, plan.bn, plan.bk) == (32, 64, 8)
    plan = _plan(100, 100, 100, backend="pallas", bm=16)
    assert plan.source == "override" and plan.bm == 16
    assert _plan(16, 16, 16, backend="pallas").source == "heuristic"
    assert _plan(100, 100, 100, backend="pallas",
                 use_cache=False).source == "heuristic"


def test_malformed_cache_entry_degrades_to_heuristic(tmp_cache):
    key = gemm.cache_key("cpu", "float64", 100, 100, 100, "pallas")
    tmp_cache.put(key, {"bm": 0, "bn": "lots", "bk": 8})
    plan = _plan(100, 100, 100, backend="pallas")
    assert plan.source == "heuristic" and plan.bm > 0


@pytest.mark.parametrize("garbage", [
    b'{"cpu/float64/128x128x128/pallas": {"bm": 32',  # truncated write
    b"\x00\x80 not json at all \xff",                 # binary noise
    b"[1, 2, 3]",                                     # valid JSON, wrong shape
])
def test_corrupt_cache_file_warns_and_retunes(tmp_path, garbage):
    path = tmp_path / "corrupt.json"
    path.write_bytes(garbage)
    cache = gemm.PlanCache(str(path))
    gemm.set_default_cache(cache)
    try:
        with pytest.warns(RuntimeWarning, match="cache"):
            plan = _plan(100, 100, 100, backend="pallas")
        assert plan.source == "heuristic" and plan.bm > 0
        key = gemm.cache_key("cpu", "float64", 100, 100, 100, "pallas")
        cache.put(key, {"bm": 32, "bn": 64, "bk": 8})
        assert gemm.PlanCache(str(path)).get(key) == \
            {"bm": 32, "bn": 64, "bk": 8}
        replan = _plan(100, 100, 100, backend="pallas")
        assert replan.source == "tuned" and replan.bm == 32
    finally:
        gemm.set_default_cache(None)


def test_autotune_persists_winner(tmp_cache, monkeypatch):
    # tuned under backend="auto": the entry lands under the resolved name
    monkeypatch.setenv("REPRO_GEMM_BACKEND", "pallas")
    cands = [{"bm": 16, "bn": 16, "bk": 8}, {"bm": 32, "bn": 32, "bk": 16}]
    plan = gemm.autotune(32, 32, 32, backend="auto", candidates=cands,
                         iters=1, platform="cpu")
    assert plan.source == "tuned"
    assert {"bm": plan.bm, "bn": plan.bn, "bk": plan.bk} in cands
    replanned = _plan(32, 32, 32, backend="pallas")
    assert replanned.source == "tuned"
    assert (replanned.bm, replanned.bn, replanned.bk) == \
        (plan.bm, plan.bn, plan.bk)


@pytest.mark.parametrize("precision", ["dd", "td", "qd"])
def test_candidates_fit_the_kernels_shared_memory(precision):
    # kernel #1 reads no block field: one candidate; kernel #2 reads bk and
    # n_slices, and each candidate's shared memory fits a Hopper block
    assert len(gemm.candidate_blocks(4096, 4096, 4096, "pallas")) == 1
    blocks = gemm.candidate_blocks(4096, 4096, 4096, "ozaki-pallas")
    assert len({b["bk"] for b in blocks}) == len(blocks) >= 3
    from repro_torch.gemm.autotune import _expand_slice_candidates

    cands = _expand_slice_candidates(4096, 4096, 4096, blocks,
                                     torch.float64, precision, "cpu")
    assert cands
    for c in cands:
        assert smem_bytes(c["bk"], c["n_slices"]) <= SMEM_LIMIT
    dropped = [b for b in blocks
               if not any(c["bk"] == b["bk"] for c in cands)]
    for b in dropped:  # only what does not fit is dropped
        plan = _plan(4096, 4096, 4096, precision=precision,
                     backend="ozaki-pallas", use_cache=False, **b)
        assert smem_bytes(plan.bk, plan.n_slices) > SMEM_LIMIT


def test_shape_bucket():
    assert gemm.shape_bucket(100, 100, 100) == "128x128x128"
    assert gemm.shape_bucket(128, 16, 1) == "128x16x8"


@pytest.mark.parametrize("args", [
    ("cpu", "float64", 100, 100, 100, "pallas"),
    ("cpu", "float64", 24, 24, 24, "ozaki-pallas", 4, (5,)),
    ("cpu", "float64", 2048, 64, 1984, "xla", 3, (2, 3)),
])
def test_cache_key_equals_the_reference(args):
    assert gemm.cache_key(*args) == jgemm.cache_key(*args)
    assert gemm.cache_key(*args).startswith(f"v{tcache.SCHEMA}/")
    assert tcache.SCHEMA == jgemm.cache.SCHEMA
    assert gemm.cache_key("cuda", *args[1:]).split("/")[1] == "cuda"


def test_batched_plans_tune_apart_from_2d_bucket(tmp_cache):
    k2d = gemm.cache_key("cpu", "float64", 100, 100, 100, "pallas")
    tmp_cache.put(k2d, {"bm": 32, "bn": 64, "bk": 8})
    plan = _plan(100, 100, 100, backend="pallas", batch_shape=(5,))
    assert plan.source == "heuristic"  # the 2-D entry is not reused
    kb = gemm.cache_key("cpu", "float64", 100, 100, 100, "pallas",
                        batch_shape=(5,))
    assert kb != k2d
    tmp_cache.put(kb, {"bm": 16, "bn": 32, "bk": 8})
    plan = _plan(100, 100, 100, backend="pallas", batch_shape=(5,))
    assert plan.source == "tuned"
    assert (plan.bm, plan.bn, plan.bk) == (16, 32, 8)
    assert gemm.cache_key("cpu", "float64", 100, 100, 100, "pallas",
                          batch_shape=(2, 3)) == \
        gemm.cache_key("cpu", "float64", 100, 100, 100, "pallas",
                       batch_shape=(8,))


def test_schema_v4_orphans_v3_rows_and_stale_quarantine(tmp_path):
    path = tmp_path / "plans.json"
    v3_rows = {
        "v3/cpu/float64/b1/128x128x128/pallas": {"bm": 64, "bn": 64,
                                                 "bk": 16},
        "v3/cpu/float64x4/b1/128x128x128/pallas": {"bm": 8, "bn": 8,
                                                   "bk": 8},
        "quarantine/v1/cpu/ozaki-pallas/x2": {"reason": "old",
                                              "unix_time": "not-a-time"},
        "quarantine/v1/cpu/pallas/x3": {"reason": "no ts"},
    }
    path.write_text(json.dumps(v3_rows))
    cache = gemm.PlanCache(str(path))
    gemm.set_default_cache(cache)
    try:
        for prec in ("dd", "qd"):
            assert _plan(100, 100, 100, backend="pallas",
                         precision=prec).source == "heuristic"
        assert gemm.quarantined("cpu", "ozaki-pallas", 2) is None
        assert gemm.quarantined("cpu", "pallas", 3) is None
        for prec, nl in (("dd", 2), ("td", 3), ("qd", 4)):
            key = gemm.cache_key("cpu", "float64", 100, 100, 100, "pallas",
                                 nlimbs=nl)
            assert key.startswith("v4/") and f"float64x{nl}" in key
            cache.put(key, {"bm": 16, "bn": 32, "bk": 8})
            plan = _plan(100, 100, 100, backend="pallas", precision=prec)
            assert plan.source == "tuned"
            assert (plan.bm, plan.bn, plan.bk) == (16, 32, 8)
        on_disk = json.loads(path.read_text())
        assert all(k in on_disk for k in v3_rows)
    finally:
        gemm.set_default_cache(None)


def test_quarantine_records_are_stored(tmp_cache):
    # storage only: the planner does not consult them (ROADMAP.md item 4)
    gemm.quarantine("cpu", "ozaki-pallas", 3, reason="launch failed")
    entry = gemm.quarantined("cpu", "ozaki-pallas", 3)
    assert entry["reason"] == "launch failed"
    assert gemm.quarantined("cpu", "ozaki-pallas", 2) is None
    assert _plan(64, 64, 64, precision="td",
                 backend="ozaki-pallas").backend == "ozaki-pallas"
    assert gemm.clear_quarantine() == 1
    assert gemm.quarantined("cpu", "ozaki-pallas", 3) is None


def test_autotune_populates_batched_bucket(tmp_cache):
    cands = [{"bm": 16, "bn": 16, "bk": 8}, {"bm": 8, "bn": 8, "bk": 8}]
    plan = gemm.autotune(16, 16, 16, backend="xla", batch_shape=(4,),
                         candidates=cands, iters=1, platform="cpu")
    assert plan.batch == "vmap"
    replan = _plan(16, 16, 16, backend="xla", batch_shape=(4,))
    assert replan.source == "tuned"
    assert (replan.bm, replan.bn, replan.bk) == (plan.bm, plan.bn, plan.bk)
    assert _plan(16, 16, 16, backend="xla").source == "heuristic"


def test_explicit_cache_beats_env_var(tmp_cache, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_GEMM_CACHE",
                       str(tmp_path / "other.json"))
    assert gemm.default_cache() is tmp_cache


def test_env_var_names_the_ports_own_file(tmp_path, monkeypatch):
    # the port's file is not the reference's: $REPRO_TORCH_GEMM_CACHE, else
    # ~/.cache/repro_torch/gemm_plans.json
    monkeypatch.setenv("REPRO_TORCH_GEMM_CACHE", str(tmp_path / "t.json"))
    monkeypatch.setenv("REPRO_GEMM_CACHE", str(tmp_path / "j.json"))
    assert gemm.default_cache().path == str(tmp_path / "t.json")
    monkeypatch.delenv("REPRO_TORCH_GEMM_CACHE")
    assert gemm.default_cache().path.endswith(
        "/.cache/repro_torch/gemm_plans.json")


def test_autotune_persists_n_slices(tmp_cache):
    plan = gemm.autotune(24, 24, 24, backend="ozaki-pallas",
                         candidates=[{"bm": 8, "bn": 8, "bk": 8},
                                     {"bm": 24, "bn": 24, "bk": 8,
                                      "n_slices": 6}],
                         iters=1, platform="cpu")
    assert plan.source == "tuned" and plan.backend == "ozaki-pallas"
    key = gemm.cache_key("cpu", "float64", 24, 24, 24, "ozaki-pallas")
    entry = tmp_cache.get(key)
    assert entry is not None and entry["n_slices"] == plan.n_slices
    replanned = _plan(24, 24, 24, backend="ozaki-pallas")
    assert replanned.source == "tuned"
    assert (replanned.bm, replanned.bn, replanned.bk, replanned.n_slices) \
        == (plan.bm, plan.bn, plan.bk, plan.n_slices)


def test_autotune_default_candidates_for_the_slicing_kernel(tmp_cache):
    plan = gemm.autotune(40, 40, 40, backend="ozaki-pallas", iters=1,
                         platform="cpu")
    replanned = _plan(40, 40, 40, backend="ozaki-pallas")
    assert replanned.source == "tuned"
    assert (replanned.bk, replanned.n_slices) == (plan.bk, plan.n_slices)
    minimum = _plan(40, 40, 40, backend="ozaki-pallas", bk=plan.bk,
                    use_cache=False).n_slices
    assert plan.n_slices in (minimum, minimum + 1)


@pytest.mark.parametrize("override", [
    {"slice_dtype": "bfloat16", "acc_dtype": "float32"},
    {"slice_dtype": "bfloat16"},
    {"acc_dtype": "float32"},
    {"target_bits": 120},
])
def test_tuned_n_slices_not_adopted_under_override(tmp_cache, override):
    # a count tuned for f64/f64 at the default target would under-cover a
    # bf16 plan by ~70 bits: any dtype or target override re-solves it,
    # exactly as the reference's planner does
    key = gemm.cache_key("cpu", "float64", 24, 24, 24, "ozaki-pallas")
    tmp_cache.put(key, {"bm": 24, "bn": 24, "bk": 8, "n_slices": 5})
    jkey = jgemm.cache_key("cpu", "float64", 24, 24, 24, "ozaki-pallas")
    jcache = jgemm.PlanCache(tmp_cache.path + ".ref")
    jcache.put(jkey, {"bm": 24, "bn": 24, "bk": 8, "n_slices": 5})
    jgemm.set_default_cache(jcache)
    try:
        jplan = jgemm.make_plan(24, 24, 24, backend="ozaki-pallas",
                                platform="cpu", **override)
    finally:
        jgemm.set_default_cache(None)
    plan = _plan(24, 24, 24, backend="ozaki-pallas", **override)
    assert plan.source == jplan.source == "tuned"
    assert (plan.bk, plan.slice_beta, plan.n_slices) == \
        (jplan.bk, jplan.slice_beta, jplan.n_slices)
    assert plan.n_slices != 5
    assert plan.slice_beta * plan.n_slices >= \
        (override.get("target_bits") or 107)
    # without an override the tuned count is adopted
    assert _plan(24, 24, 24, backend="ozaki-pallas").n_slices == 5


def test_narrow_plan_runs_after_tuning(tmp_cache):
    # a tuned f64 bucket and a narrow plan in it: the narrow product still
    # covers the dd target through the port's engine
    gemm.autotune(24, 24, 24, backend="ozaki-pallas", iters=1,
                  platform="cpu")
    rng = np.random.default_rng(3)
    from repro_torch.core import dd
    from repro_torch.core.accuracy import max_rel_err

    a = dd.from_float(rng.standard_normal((24, 24)), device="cpu")
    b = dd.from_float(rng.standard_normal((24, 24)), device="cpu")
    got = gemm.matmul(a, b, backend="ozaki-pallas", slice_dtype="bfloat16",
                      acc_dtype="float32")
    want = gemm.matmul(a, b, backend="ref")
    assert max_rel_err(got, want) < 2.0 ** -90
