"""The GEMM engine of the port: plan -> (auto)tune -> dispatch.

    plan = make_plan(m, k, n, backend=..., platform="cuda")
    c    = execute(plan, a, b)        # or matmul(a, b, ...) to do both

``make_plan`` adopts tuned blocks (and, for ``ozaki-pallas``, a tuned
slice count) from the port's plan cache, which ``autotune`` fills.
"""

from .autotune import autotune, candidate_blocks, smem_bytes
from .cache import (PlanCache, batch_bucket, cache_key, clear_quarantine,
                    default_cache, quarantine, quarantined,
                    set_default_cache, shape_bucket)
from .engine import execute, matmul
from .plan import (BACKENDS, DEFAULT_BLOCKS, OZAKI_TARGET_BITS, PRECISIONS,
                   GemmPlan, make_plan, resolve_backend)

__all__ = ["BACKENDS", "DEFAULT_BLOCKS", "OZAKI_TARGET_BITS", "PRECISIONS",
           "GemmPlan", "make_plan", "resolve_backend", "execute", "matmul",
           "autotune", "candidate_blocks", "smem_bytes",
           "PlanCache", "batch_bucket", "cache_key", "default_cache",
           "set_default_cache", "shape_bucket",
           "quarantine", "quarantined", "clear_quarantine"]
