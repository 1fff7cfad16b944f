"""Block-shape autotuner: the runtime analogue of the paper's M_Tile sweep.

The port of ``repro.gemm.autotune``.  Candidate plans are filtered by a
resource model, timed on live data, and the winner is persisted through
``cache.PlanCache``, so every later ``make_plan`` in the same bucket
adopts it.  The reference's model is the TPU's (VMEM working sets, the
VPU's rate); this one is what the CUDA kernels actually read and hold:

  * kernel #1 (``pallas``, ``csrc/mlgemm.cu``) tiles the output itself
    (64x64 per CTA, K staged 16 deep) and reads no block field of the
    plan, so it has one candidate;
  * kernel #2 (``ozaki-pallas``, ``csrc/ozgemm.cu`` and
    ``csrc/ozgemm_narrow.cu``) reads ``bk`` and ``n_slices`` only; a
    candidate fits when the kernel's own shared-memory count
    (``kernels.ozgemm.smem_bytes``, the sources' ``ozgemm_smem_bytes``)
    is within the 232,448 B a Hopper block may hold;
  * ``xla`` (the K-chunked tier loop) reads ``bk`` only.

Candidates are deduplicated on the fields the launched kernel reads.  A
tuned ``bk`` changes kernel #2's bits (its slabs, and so its slices, are
``bk`` deep): the reference accepts that, and so does the port.  A tuned
``n_slices`` is never below the exactness minimum for its slab depth.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import mp
from ..kernels.ozgemm import SMEM_LIMIT, smem_bytes
from . import cache as plan_cache
from .plan import (DEFAULT_BLOCKS, PRECISIONS, GemmPlan, _clamp_blocks,
                   make_plan, resolve_backend, resolve_platform)

__all__ = ["autotune", "candidate_blocks", "smem_bytes", "SMEM_LIMIT"]

# sweep grid: the reference's (bm, bn, bk) shapes, the heuristic first
_SWEEP: Tuple[Tuple[int, int, int], ...] = (
    (DEFAULT_BLOCKS["bm"], DEFAULT_BLOCKS["bn"], DEFAULT_BLOCKS["bk"]),
    (32, 32, 8), (32, 32, 32), (64, 64, 8), (64, 64, 16), (64, 64, 32),
    (128, 128, 8), (128, 128, 16), (128, 128, 64), (128, 256, 16),
    (256, 128, 16),
)

# the plan fields each backend's kernel reads on the card
_READS = {"pallas": (), "ozaki-pallas": ("bk",), "xla": ("bk",),
          "ozaki": (), "ref": ()}


def candidate_blocks(m: int, k: int, n: int,
                     backend: str = "pallas") -> List[dict]:
    """Sweep candidates clamped to the problem, one per distinct set of
    the fields ``backend``'s kernel reads (the heuristic first)."""
    out, seen = [], set()
    reads = _READS[resolve_backend(backend)]
    for bm, bn, bk in _SWEEP:
        blk = _clamp_blocks(m, k, n, {"bm": bm, "bn": bn, "bk": bk})
        key = tuple(blk[x] for x in reads)
        if key not in seen:
            seen.add(key)
            out.append(blk)
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_once(fn, device, warmup: int = 1, iters: int = 2) -> float:
    """Median host time of ``fn`` over ``iters`` runs, each ended by a
    device synchronization."""
    for _ in range(warmup):
        fn()
        _sync(device)
    times = []
    for _ in range(iters):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _expand_slice_candidates(m: int, k: int, n: int, blocks: Sequence[dict],
                             dtype, precision: str,
                             platform: str) -> List[dict]:
    """Cross block candidates with ``n_slices`` for the slicing kernel: the
    exactness minimum for the slab depth and one more, where the kernel's
    shared memory holds them.  Counts below the minimum would lose bits,
    so they are never candidates."""
    out = []
    for blk in blocks:
        base = make_plan(m, k, n, dtype=dtype, precision=precision,
                         backend="ozaki-pallas", platform=platform,
                         use_cache=False, **blk)
        if base.backend != "ozaki-pallas":
            continue  # slicing infeasible for this problem: plan fell back
        for ns in (base.n_slices, base.n_slices + 1):
            if smem_bytes(base.bk, ns, base.slice_dtype,
                          base.acc_dtype or "float64") <= SMEM_LIMIT:
                out.append(dict(blk, n_slices=ns))
    return out


def autotune(m: int, k: int, n: int, *, dtype=torch.float64,
             precision: str = "dd", backend: str = "pallas",
             batch_shape: Tuple[int, ...] = (),
             candidates: Optional[Sequence[dict]] = None,
             cache: Optional[plan_cache.PlanCache] = None,
             platform: Optional[str] = None, seed: int = 0, iters: int = 2,
             persist: bool = True) -> GemmPlan:
    """Sweep block shapes on live data, persist the winner, return its plan.

    Returns the tuned ``GemmPlan`` for the (m, k, n) problem at the given
    precision tier; later ``make_plan`` calls in the same (shape bucket,
    limb count, batch bucket, platform) pick the entry up from the cache.
    ``batch_shape`` times the sweep on batched operands and persists under
    the batched bucket.  For ``backend="ozaki-pallas"`` the search space is
    ``bk`` x ``n_slices`` (never below the exactness minimum) and the
    winner's slice count is persisted beside its blocks.  ``platform=None``
    means ``cuda`` (and raises without CUDA).
    """
    from . import engine

    platform = resolve_platform(platform)
    nlimbs = PRECISIONS[precision]
    backend = resolve_backend(backend)  # key the cache on the resolved name
    cache = cache or plan_cache.default_cache()
    if candidates is not None:
        candidates = list(candidates)
    else:
        candidates = candidate_blocks(m, k, n, backend)
        if backend == "ozaki-pallas":
            candidates = _expand_slice_candidates(
                m, k, n, candidates, dtype, precision, platform)
    if not candidates:
        raise ValueError(f"no feasible block candidates for {(m, k, n)}")

    device = torch.device(platform)
    rng = np.random.default_rng(seed)
    batch_shape = tuple(batch_shape)
    a = mp.from_float(torch.as_tensor(
        rng.random(batch_shape + (m, k)) - 0.5, dtype=dtype, device=device),
        precision)
    b = mp.from_float(torch.as_tensor(
        rng.random((k, n)) - 0.5, dtype=dtype, device=device), precision)

    best, best_t = None, float("inf")
    for cand in candidates:
        blk = {x: cand[x] for x in ("bm", "bn", "bk")}
        plan = make_plan(m, k, n, dtype=dtype, precision=precision,
                         backend=backend, batch_shape=batch_shape,
                         platform=platform, use_cache=False,
                         n_slices=cand.get("n_slices"), **blk)
        t = _time_once(lambda: engine.execute(plan, a, b), device,
                       iters=iters)
        if t < best_t:
            best, best_t = plan, t

    if persist:
        # the entry lands under the bucket that was actually timed: the
        # 2-D (b1) bucket, or the batched bucket when a batch was swept
        key = plan_cache.cache_key(
            best.platform, str(dtype).removeprefix("torch."), m, k, n,
            backend, nlimbs=nlimbs, batch_shape=batch_shape)
        entry = {"bm": best.bm, "bn": best.bn, "bk": best.bk,
                 "us_per_call": best_t * 1e6,
                 "bucket": plan_cache.shape_bucket(m, k, n)}
        if best.backend == "ozaki-pallas" and best.n_slices:
            entry["n_slices"] = int(best.n_slices)
        cache.put(key, entry)
    return best.with_(source="tuned")
