"""The GEMM engine of the port: plan -> dispatch (single device, 2-D).

    plan = make_plan(m, k, n, backend=..., platform="cuda")
    c    = execute(plan, a, b)        # or matmul(a, b, ...) to do both
"""

from .engine import execute, matmul
from .plan import (BACKENDS, DEFAULT_BLOCKS, OZAKI_TARGET_BITS, PRECISIONS,
                   GemmPlan, make_plan, resolve_backend)

__all__ = ["BACKENDS", "DEFAULT_BLOCKS", "OZAKI_TARGET_BITS", "PRECISIONS",
           "GemmPlan", "make_plan", "resolve_backend", "execute", "matmul"]
