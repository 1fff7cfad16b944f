#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) end to end on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

  1. the card (name and power limit from nvidia-smi) and the build of both
     hand-written kernels from csrc/ (nvcc, one process per source);
  2. each kernel against its plain PyTorch version on the card, bit for bit:
     kernel #1 (csrc/mlgemm.cu) at 512^3, a ragged 509x263x131, the
     Hilbert gate's 32^3, an LU trailing update 1984x64x1984 and a
     residual 2048x2048x4; kernel #2 (csrc/ozgemm.cu) at 512^3, 509x263x131
     and the Hilbert 32^3, each with epilogues none, alpha and full;
  3. the main path, with every launch counter set to 0 first: dd Rgemm
     C = alpha*A@B + beta*C at n = 4096 through rgemm on backend
     ozaki-pallas (kernel #2, fused drain) and on pallas (kernel #1), the
     two held within 16*k*2^-104 of each other;
  4. the Hilbert dd accuracy gate (<= 2^-100 against the exact Fraction
     oracle, n = 32) on both kernels;
  5. blocked LU rgetrf at n = 2048, block 64, backend pallas, gated by
     ||PA - LU|| / (n ||A|| u_dd) <= 30 with the residual formed in dd on
     the card, then lu_solve;
  6. the refined solve rgesv at n = 2048 with 4 right-hand sides (f64
     factor, dd target, backend pallas), converged to a backward error
     <= 4 n u_dd, and an ill-conditioned n = 2048 system (singular values
     spanning 1e20) that escalates f64 -> dd, so that a dd rgetrf (block
     64) runs inside rgesv;
  7. the launch counts of phases 3-6 (each kernel must have run there),
     then each kernel's time at the Rgemm shape beside its bound, its plain
     version's time and output there (held bit for bit again), and (as
     context only: no PyTorch call computes a dd GEMM) an f64
     torch.matmul at the same shape.

The last two lines are a JSON object {"kernels": [...]} and
{"ok": true, "device": {...}}.  Without CUDA, or without the repository's
src/repro_torch beside it, the script exits non-zero and prints neither.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

U_DD = 2.0 ** -106
ULP_DD = 2.0 ** -104

# H100 SXM peaks (NVIDIA's data sheet) for the bounds: f64 outside the
# tensor cores, and HBM3 bandwidth
F64_PEAK = 34e12
HBM_BYTES_PER_S = 3.35e12
# f64 add/sub/mul operations per dd FMA in csrc/mlgemm.cu's inner loop
MLGEMM_OPS_PER_FMA = 51
# per operand element and slice in csrc/ozgemm.cu's extraction: the
# (hi + sigma) - sigma pair, the dd subtract (20) and the anchor step
OZGEMM_OPS_PER_SLICE = 23
ADD_FLOAT_OPS = 10      # dd.add_float, one fold per output per diagonal
DD_MUL_OPS, DD_ADD_OPS = 31, 20


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run it from "
              f"a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))

    from repro_torch.core import dd, mp
    from repro_torch.core.accuracy import (GATES, hilbert_relative_error,
                                           hilbert_tier, max_rel_err)
    from repro_torch.core.blas import rgemm, rlange
    from repro_torch.core.linalg import apply_pivots, lu_solve, rgetrf
    from repro_torch.gemm import make_plan, matmul
    from repro_torch.kernels import _build, mlgemm, ozgemm
    from repro_torch.solve import rgesv

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(20230607)

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def rand_dd(m, n):
        hi = torch.randn(m, n, generator=gen, device=dev, dtype=torch.float64)
        lo = torch.randn(m, n, generator=gen, device=dev,
                         dtype=torch.float64) * 2.0 ** -53
        return dd.from_hi_lo(hi, lo)

    def dd_scalar(num, den):
        one = dd.from_float(torch.tensor(float(num), dtype=torch.float64,
                                         device=dev))
        return dd.div(one, dd.from_float(torch.tensor(
            float(den), dtype=torch.float64, device=dev)))

    # ---- 1. the card and the build -------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    logs, t_build = sync_time(_build.build_all)
    log(f"phase 1: built {', '.join(_build.SOURCES)} in {t_build:.2f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line:
                log(f"phase 1: {name}: {line.strip()}")

    # ---- 2. kernels against their plain versions, bit for bit ----------
    t2 = time.perf_counter()
    max_err = {"mlgemm": 0.0, "ozgemm": 0.0}

    def compare(name, got_limbs, want):
        err = max(float(torch.max(torch.abs(g - w))) if g.numel() else 0.0
                  for g, w in zip(got_limbs, mp.limbs(want)))
        same = all(torch.equal(g, w) for g, w in zip(got_limbs,
                                                     mp.limbs(want)))
        max_err[name] = max(max_err[name], err)
        return same, err

    # at the shapes the main path gives the kernels: square, ragged, the
    # Hilbert gate's 32^3 (its own inputs), the first LU trailing update
    # (1984x64x1984) and a residual A @ X (2048x2048x4)
    hil = hilbert_tier("dd", 32, device="cuda")
    cases = [("512^3", rand_dd(512, 512), rand_dd(512, 512)),
             ("509x263x131", rand_dd(509, 263), rand_dd(263, 131)),
             ("Hilbert 32^3", hil, hil)]
    for label, a, b in cases + [
            ("1984x64x1984", rand_dd(1984, 64), rand_dd(64, 1984)),
            ("2048x2048x4", rand_dd(2048, 2048), rand_dd(2048, 4))]:
        got = mlgemm.mlgemm_kernel_call(*mp.limbs(a), *mp.limbs(b))
        same, err = compare("mlgemm", got, mlgemm.mlgemm_plain(a, b))
        log(f"phase 2: mlgemm {label} kernel == plain: {same} "
            f"(max abs diff {err:.3e})")
        check(same, f"mlgemm {label} differs from its plain version")
    alpha, beta = dd_scalar(1, 3), dd_scalar(-1, 7)
    for label, a, b in cases:
        (m, k), n = a.shape, b.shape[1]
        c = rand_dd(m, n)
        # the plan the engine makes for this shape gives the kernel its
        # slab depth and solved slicing, as on the main path
        plan = make_plan(m, k, n, backend="ozaki-pallas", platform="cuda")
        for epi in ozgemm.EPILOGUES:
            ops = [*mp.limbs(a), *mp.limbs(b)]
            kw = {}
            if epi != "none":
                ops += [l.reshape(1, 1) for l in mp.limbs(alpha)]
                kw["alpha"] = alpha
            if epi == "full":
                ops += [*[l.reshape(1, 1) for l in mp.limbs(beta)],
                        *mp.limbs(c)]
                kw.update(beta_s=beta, c=c)
            got = ozgemm.ozgemm_kernel_call(
                *ops, bk=plan.bk, beta=plan.slice_beta,
                n_slices=plan.n_slices, epilogue=epi)
            want = ozgemm.ozgemm_plain(a, b, bk=plan.bk,
                                       beta=plan.slice_beta,
                                       n_slices=plan.n_slices, **kw)
            same, err = compare("ozgemm", got, want)
            log(f"phase 2: ozgemm {label} epilogue={epi} (bk={plan.bk}, "
                f"beta={plan.slice_beta}, n_slices={plan.n_slices}) "
                f"kernel == plain: {same} (max abs diff {err:.3e})")
            check(same, f"ozgemm {label} epilogue={epi} differs from its "
                  f"plain version")
    log(f"phase 2: {time.perf_counter() - t2:.1f} s")

    # ---- 3. the main path: dd Rgemm at n = 4096 ------------------------
    mlgemm.launches = 0
    ozgemm.launches = 0
    n = 4096
    A, B, C = rand_dd(n, n), rand_dd(n, n), rand_dd(n, n)
    alpha, beta = dd_scalar(1, 3), dd_scalar(-1, 7)
    outs = {}
    for backend in ("ozaki-pallas", "pallas"):
        outs[backend], t = sync_time(lambda: rgemm(
            "n", "n", alpha, A, B, beta, C, backend=backend))
        log(f"phase 3: rgemm n={n} backend={backend}: {t:.4f} s, "
            f"{2 * n ** 3 / t / 1e12:.4f} binary128-class TFLOP/s "
            f"(2mnk/s)")
    err = max_rel_err(outs["ozaki-pallas"], outs["pallas"])
    log(f"phase 3: max_rel_err(ozaki-pallas, pallas) = {err:.3e} "
        f"(2^{torch.log2(torch.tensor(err)).item():.1f}; bound "
        f"16*k*2^-104 = {16 * n * ULP_DD:.3e})")
    check(err <= 16 * n * ULP_DD, "the two Rgemm backends disagree")
    check(all(bool(torch.isfinite(l).all()) for o in outs.values()
              for l in mp.limbs(o)), "non-finite Rgemm output")
    del outs

    # ---- 4. the Hilbert accuracy gate ----------------------------------
    for backend in ("pallas", "ozaki-pallas"):
        err, t = sync_time(lambda: hilbert_relative_error(
            "dd", 32, backend, device="cuda"))
        log(f"phase 4: Hilbert n=32 dd {backend}: rel err {err:.3e} "
            f"(gate {GATES['dd']:.3e}) in {t:.2f} s")
        check(err <= GATES["dd"], f"Hilbert gate on {backend}")

    # ---- 5. blocked LU and lu_solve at n = 2048 ------------------------
    n = 2048
    A = dd.from_float(torch.randn(n, n, generator=gen, device=dev,
                                  dtype=torch.float64))
    (lu, piv), t = sync_time(lambda: rgetrf(A, block=64, backend="pallas"))
    log(f"phase 5: rgetrf n={n} block=64 backend=pallas: {t:.2f} s")
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    low = dd.DD(torch.tril(lu.hi, -1) + eye, torch.tril(lu.lo, -1))
    up = dd.DD(torch.triu(lu.hi), torch.triu(lu.lo))
    resid = dd.sub(apply_pivots(A, piv), matmul(low, up, backend="pallas"))
    ratio = float(torch.max(torch.abs(dd.to_float(resid)))) / (
        n * float(rlange("m", A)) * U_DD)
    log(f"phase 5: ||PA - LU|| / (n ||A|| u_dd) = {ratio:.3f} (gate 30)")
    check(ratio <= 30.0, "LU residual ratio")
    x_true = rand_dd(n, 2)
    rhs = matmul(A, x_true, backend="pallas")
    x, t = sync_time(lambda: lu_solve(lu, piv, rhs))
    r = rgemm("n", "n", -1.0, A, x, 1.0, rhs, backend="pallas")
    berr = float(torch.max(torch.abs(dd.to_float(r)))) / (
        float(rlange("i", A)) * float(torch.max(torch.abs(x.hi)))
        + float(torch.max(torch.abs(rhs.hi))))
    log(f"phase 5: lu_solve n={n} nrhs=2: {t:.2f} s, backward error "
        f"{berr:.3e} ({berr / (n * U_DD):.3f} n u_dd, gate 30)")
    check(berr <= 30 * n * U_DD, "lu_solve backward error")
    del lu, low, up, resid

    # ---- 6. the refined solve ------------------------------------------
    a64 = torch.randn(n, n, generator=gen, device=dev, dtype=torch.float64)
    b64 = a64 @ torch.randn(n, 4, generator=gen, device=dev,
                            dtype=torch.float64)
    (x, info), t = sync_time(lambda: rgesv(
        a64, b64, factor_tier="f64", target_tier="dd", backend="pallas"))
    log(f"phase 6: rgesv n={n} nrhs=4 f64->dd pallas: {t:.2f} s, "
        f"converged={info.converged} in {info.iterations} iterations, "
        f"backward errors {[f'{e:.2e}' for e in info.backward_errors]}")
    check(info.converged and info.final_backward_error <= 4 * n * U_DD,
          "rgesv did not converge to 4 n u_dd")
    q, _ = torch.linalg.qr(torch.randn(n, n, generator=gen, device=dev,
                                       dtype=torch.float64))
    sig = torch.logspace(0, -20, n, dtype=torch.float64, device=dev)
    # Q diag(sig) Q^T formed in dd: its singular values are sig to ~1e-16
    # relative, so cond ~ 1e20 holds in dd (an f64 rounding would not)
    ill = matmul(dd.from_float(q * sig), dd.from_float(q.T.contiguous()),
                 backend="pallas")
    bi = matmul(ill, dd.from_float(torch.ones(n, 1, dtype=torch.float64,
                                              device=dev)), backend="pallas")
    (x, info), t = sync_time(lambda: rgesv(
        ill, bi, factor_tier="f64", target_tier="dd", backend="pallas",
        block=64))
    log(f"phase 6: rgesv n={n} (singular values 1 .. 1e-20) f64->dd "
        f"pallas: {t:.2f} s, converged={info.converged} in "
        f"{info.iterations} iterations, escalations "
        f"{[(e['iteration'], e['from'], e['to']) for e in info.escalations]},"
        f" factorizations {info.factorizations}, final backward error "
        f"{info.final_backward_error:.3e}")
    check(info.converged and info.factorizations.get("dd") == 1
          and info.final_backward_error <= 4 * n * U_DD,
          "the ill-conditioned rgesv did not converge through a dd rgetrf")
    launches = {"mlgemm": mlgemm.launches, "ozgemm": ozgemm.launches}
    log(f"phase 3-6: kernel launches on the main path: {launches}")
    check(all(v > 0 for v in launches.values()),
          "a kernel of the main path never launched")

    # ---- 7. times at the Rgemm shape -----------------------------------
    n = 4096
    A, B, C = rand_dd(n, n), rand_dd(n, n), rand_dd(n, n)
    alpha, beta = dd_scalar(1, 3), dd_scalar(-1, 7)
    plan = make_plan(n, n, n, backend="ozaki-pallas", platform="cuda")
    oz_ops = [*mp.limbs(A), *mp.limbs(B),
              *[l.reshape(1, 1) for l in mp.limbs(alpha)],
              *[l.reshape(1, 1) for l in mp.limbs(beta)], *mp.limbs(C)]
    oz_kw = dict(bk=plan.bk, beta=plan.slice_beta, n_slices=plan.n_slices,
                 epilogue="full")

    def event_ms(fn, reps):
        fn()  # warm up
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    ml_ms = event_ms(lambda: mlgemm.mlgemm_kernel_call(
        *mp.limbs(A), *mp.limbs(B)), 3)
    oz_ms = event_ms(lambda: ozgemm.ozgemm_kernel_call(*oz_ops, **oz_kw), 3)
    # the plain versions at the same shape, timed once, and held against
    # the kernels' outputs bit for bit
    want, t = sync_time(lambda: mlgemm.mlgemm_plain(A, B))
    ml_plain_ms = t * 1e3
    same, err = compare("mlgemm", mlgemm.mlgemm_kernel_call(
        *mp.limbs(A), *mp.limbs(B)), want)
    log(f"phase 7: mlgemm {n}^3 kernel == plain: {same} "
        f"(max abs diff {err:.3e})")
    check(same, f"mlgemm {n}^3 differs from its plain version")
    want, t = sync_time(lambda: ozgemm.ozgemm_plain(
        A, B, bk=plan.bk, beta=plan.slice_beta, n_slices=plan.n_slices,
        alpha=alpha, beta_s=beta, c=C))
    oz_plain_ms = t * 1e3
    same, err = compare("ozgemm", ozgemm.ozgemm_kernel_call(
        *oz_ops, **oz_kw), want)
    log(f"phase 7: ozgemm {n}^3 epilogue=full kernel == plain: {same} "
        f"(max abs diff {err:.3e})")
    check(same, f"ozgemm {n}^3 differs from its plain version")
    del want
    f64_ms = event_ms(lambda: torch.matmul(A.hi, B.hi), 5)

    mnk = n ** 3
    ml_ops = mnk * MLGEMM_OPS_PER_FMA
    pairs = sum(len(range(max(0, d - plan.n_slices + 1),
                          min(d + 1, plan.n_slices)))
                for d in range(plan.n_slices))
    oz_ops_n = (2 * mnk * pairs
                + 2 * n * n * plan.n_slices * OZGEMM_OPS_PER_SLICE
                + n * n * (n // plan.bk) * plan.n_slices * ADD_FLOAT_OPS
                + n * n * (2 * DD_MUL_OPS + DD_ADD_OPS))
    ml_bytes = 8 * 2 * 3 * n * n          # A, B in; C out (two limbs)
    oz_bytes = 8 * 2 * 4 * n * n + 8 * 4  # A, B, C in; out; the scalars

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / F64_PEAK, nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, \
            "operations" if t_ops >= t_bytes else "bytes"

    kernels = []
    for name, route_src, replaces, ms, plain_ms, (b_ms, b_by) in (
            ("mlgemm_dd", "src/repro_torch/csrc/mlgemm.cu",
             "src/repro/kernels/mlgemm.py:90", ml_ms, ml_plain_ms,
             bound(ml_ops, ml_bytes)),
            ("ozgemm_dd", "src/repro_torch/csrc/ozgemm.cu",
             "src/repro/kernels/ozgemm.py:170", oz_ms, oz_plain_ms,
             bound(oz_ops_n, oz_bytes))):
        key = name.split("_")[0]
        kernels.append({
            "name": name, "route": "cuda", "source": route_src,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": max_err[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": [n, n, n],
            "context_f64_matmul_ms": f64_ms,
        })
        log(f"phase 7: {name} at {n}^3: {ms:.2f} ms (bound {b_ms:.2f} ms "
            f"by {b_by}, {b_ms / ms:.1%} of it), plain version "
            f"{plain_ms:.1f} ms; f64 torch.matmul (context only) "
            f"{f64_ms:.2f} ms")
    log(smi)  # exactly as nvidia-smi prints name and power limit
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
