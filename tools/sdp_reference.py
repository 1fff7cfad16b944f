#!/usr/bin/env python3
"""Run the JAX reference's SDP solver on one problem and print its result.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/sdp_reference.py \
        theta 50 0.085 0 --precision binary128 --max-iters 80

The problem is ``theta_problem(n, edge_prob, seed)`` or
``random_sdp(n, m, seed)`` (``rand n m seed [--degeneracy d]``).  The run
uses the reference's default plan (backend ``xla``) unless ``--backend``
says otherwise (``--slice-dtype``/``--acc-dtype`` add the planner's slice
overrides, e.g. ``--backend ozaki-pallas --slice-dtype bfloat16
--acc-dtype float32``, the narrow plan, in interpret mode), prints the
per-iteration history and ends with one JSON line: iterations, gap,
primal/dual infeasibility, objectives, the Schur statistics, the wall time
and the history at full precision.  ``--eager`` runs it under
``jax.disable_jit()``: every operation rounds on its own, as the port's
do (jitted, XLA:CPU contracts multiply-adds into FMAs), so the port's
iterates can be compared with it bit for bit; it is ~50x slower.  It is
how chip_smoke.py's theta1 gates were set (PERF.md).
"""

import argparse
import json
import time

import jax

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
    ap.add_argument("--slice-dtype", default=None)
    ap.add_argument("--acc-dtype", default=None)
    ap.add_argument("--eager", action="store_true")
    ns = ap.parse_args()
    gemm.set_default_cache(None)
    a, b, seed = ns.args
    if ns.kind == "theta":
        prob = theta_problem(int(a), edge_prob=b, seed=int(seed))
    else:
        prob = random_sdp(int(a), int(b), seed=int(seed),
                          degeneracy=ns.degeneracy)
    overrides = {k: v for k, v in (("backend", ns.backend),
                                   ("slice_dtype", ns.slice_dtype),
                                   ("acc_dtype", ns.acc_dtype)) if v} or None
    t = time.perf_counter()
    with jax.disable_jit(ns.eager):
        r = solve_sdp(prob, precision=ns.precision, max_iters=ns.max_iters,
                      gemm_overrides=overrides, verbose=True)
    print(json.dumps({
        "problem": prob.name, "m": prob.m, "precision": ns.precision,
        "iterations": r.iterations, "gap": r.relative_gap,
        "pfeas": r.p_feas_err, "dfeas": r.d_feas_err,
        "primal": r.primal_obj, "dual": r.dual_obj,
        "schur_stats": r.schur_stats, "eager": ns.eager,
        "seconds": time.perf_counter() - t,
        "history": [[float(v) for v in h] for h in r.history]}))


if __name__ == "__main__":
    main()
