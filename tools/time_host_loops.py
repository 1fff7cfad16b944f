#!/usr/bin/env python3
"""Time the port's host-driven loops on the card: the Cholesky factor and
solve of the SDP loop, blocked LU and its solve, and theta1's iteration.

    PYTHONPATH=<tree>/src python3 tools/time_host_loops.py [--reps 5]

It times whichever ``repro_torch`` the path gives it, so one card can
compare two trees in one session (run parent, change, change, parent):

  * ``rpotrf`` of a 50 x 50 SPD dd matrix (theta1's n; the SDP loop runs
    about ten per iteration) and ``cholesky_solve`` with 50 x 4950
    right-hand sides (its Z^-1 A_j stack, m = 99);
  * ``rgetrf`` (block 64, backend ``pallas``) and ``lu_solve`` (2
    right-hand sides) at n = 2048, chip_smoke.py's phase 5;
  * ``solve_sdp`` on ``theta_problem(50, 0.085, seed=0)`` at binary128,
    backend ``pallas``, 10 iterations: seconds per iteration.

Each is run once to build and load the kernels, then timed ``--reps``
times (the SDP twice) with ``torch.cuda.synchronize()`` around it; the
median and the least time of each are printed, with the card's name and
power limit, as one JSON line.  Host times move between processes on a
card that shares its host, so alternate the trees over several runs.
"""

import argparse
import json
import os
import statistics
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.core import dd
from repro_torch.core.linalg import cholesky_solve, lu_solve, rgetrf, rpotrf
from repro_torch.core.sdp import solve_sdp, theta_problem


def timed(fn, reps):
    """(median, min) seconds of ``reps`` timed calls after one untimed."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return statistics.median(out), min(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ns = ap.parse_args()
    # a planner with a plan cache reads this run's own (empty) file
    os.environ["REPRO_TORCH_GEMM_CACHE"] = str(
        Path(__file__).resolve().parents[1] / "build" / "time_host_loops.json")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.float64)

    g = randn(50, 50)
    spd = dd.from_float(g @ g.T + 50 * torch.eye(50, dtype=torch.float64,
                                                 device=dev))
    l50 = rpotrf(spd)
    rhs = dd.from_float(randn(50, 99 * 50))
    a = dd.from_float(randn(2048, 2048))
    lu, piv = rgetrf(a, block=64, backend="pallas")
    b = dd.from_float(randn(2048, 2))
    res = {
        "rpotrf_50_s": timed(lambda: rpotrf(spd), ns.reps),
        "cholesky_solve_50x4950_s": timed(lambda: cholesky_solve(l50, rhs),
                                          ns.reps),
        "rgetrf_2048_s": timed(lambda: rgetrf(a, block=64, backend="pallas"),
                               max(1, ns.reps // 2)),
        "lu_solve_2048_s": timed(lambda: lu_solve(lu, piv, b), ns.reps),
    }
    theta = theta_problem(50, edge_prob=0.085, seed=0)
    per_it = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = solve_sdp(theta, precision="binary128", max_iters=10,
                      gemm_overrides={"backend": "pallas"}, device=dev)
        torch.cuda.synchronize()
        per_it.append((time.perf_counter() - t) / r.iterations)
    res["theta1_binary128_s_per_iteration"] = (statistics.median(per_it),
                                               min(per_it))
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    res["repro_torch"] = __import__("repro_torch").__file__
    print(json.dumps(res))


if __name__ == "__main__":
    main()
