#!/usr/bin/env python3
"""Run the JAX reference's SDP solver on one problem and print its result.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/sdp_reference.py \
        theta 50 0.085 0 --precision binary128 --max-iters 80

The problem is ``theta_problem(n, edge_prob, seed)`` or
``random_sdp(n, m, seed)`` (``rand n m seed [--degeneracy d]``).  The run
uses the reference's default plan (backend ``xla``) unless ``--backend``
says otherwise, prints the per-iteration history and ends with one JSON
line: iterations, gap, primal/dual infeasibility, objectives, the Schur
statistics and the wall time.  It is how chip_smoke.py's theta1 gate on
the primal infeasibility was set (PERF.md).
"""

import argparse
import json
import time

from repro import gemm
from repro.core.sdp import random_sdp, solve_sdp, theta_problem


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("kind", choices=["theta", "rand"])
    ap.add_argument("args", nargs=3, type=float)
    ap.add_argument("--degeneracy", type=float, default=0.0)
    ap.add_argument("--precision", default="binary128")
    ap.add_argument("--max-iters", type=int, default=80)
    ap.add_argument("--backend", default=None)
    ns = ap.parse_args()
    gemm.set_default_cache(None)
    a, b, seed = ns.args
    if ns.kind == "theta":
        prob = theta_problem(int(a), edge_prob=b, seed=int(seed))
    else:
        prob = random_sdp(int(a), int(b), seed=int(seed),
                          degeneracy=ns.degeneracy)
    overrides = {"backend": ns.backend} if ns.backend else None
    t = time.perf_counter()
    r = solve_sdp(prob, precision=ns.precision, max_iters=ns.max_iters,
                  gemm_overrides=overrides, verbose=True)
    print(json.dumps({
        "problem": prob.name, "m": prob.m, "precision": ns.precision,
        "iterations": r.iterations, "gap": r.relative_gap,
        "pfeas": r.p_feas_err, "dfeas": r.d_feas_err,
        "primal": r.primal_obj, "dual": r.dual_obj,
        "schur_stats": r.schur_stats,
        "seconds": time.perf_counter() - t}))


if __name__ == "__main__":
    main()
