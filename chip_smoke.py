#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) end to end on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails (they
run in the order 1-6, 8, 9, 10, 7, 11):

  1. the card (name and power limit from nvidia-smi) and the build of every
     hand-written kernel from csrc/ (nvcc, one process per source, limb
     count and narrow variant, all at once), with registers and spills per
     kernel, none allowed in the dd builds of kernel #2's two GEMMs;
  2. each kernel against its plain PyTorch version on the card, bit for bit:
     kernel #1 (csrc/mlgemm.cu) at dd at 512^3, a ragged 509x263x131, the
     Hilbert gate's 32^3, an LU trailing update 1984x64x1984 and a residual
     2048x2048x4, and at td and qd at 256^3, 509x263x131, the SDP stack
     (104 x 50x50x50, A shared) and an rposv residual 104x104x1; kernel #2
     (csrc/ozgemm.cu) at dd at 512^3, 509x263x131 and the Hilbert 32^3, at
     td and qd at 256^3 and 509x263x131, each with epilogues none, alpha and
     full, plus a B-shared batch 6 x 96x80x72 per tier with the three
     epilogues; batched calls equal the looped ones for both kernels at dd,
     td and qd; kernel #2's narrow variants (csrc/ozgemm_narrow.cu:
     bf16/f32, f32/f32, f16/f32, bf16/f64 and f32/f64 slices/accumulator)
     at dd, td and qd on 509x263x131, the Hilbert 32^3 and a residual
     2048x2048x4 with the three epilogues, on the SDP stack (99 x
     50x50x50, A shared) and the B-shared batch with the three epilogues,
     batched 5 x 70x40x66 against looped, and an adversarial headroom case
     (all digits at their largest, bk = 16, dd) whose f32 diagonal sums
     must equal the same dots in f64; kernel #2's slicing pre-pass
     (csrc/ozslice.cu) against its plain version for every slice type at
     every tier on 509x263x131, the SDP stack and the B-shared batch; the
     K-panel path (a workspace budget of one byte: one slab per panel) on
     the same shapes for every slice pair at every tier; the f64
     adversarial headroom case on the DMMA kernel at dd and qd, whose f64
     diagonal sums must equal the same dots summed exactly on the host, and
     three more on the narrow kernel's tensor-core routes: f32/f32 at beta
     9 on the f16 MMA (bk 16, 4 slices), bf16/f64 at td (diagonals past
     2^24 grid units, summed in two f32 groups into f64) and f32/f64 on
     DMMA at dd, each kernel == plain and the plain sums == exact;
     the elementwise kernels (csrc/mpops.cu) at every tier on the shapes
     of the SDP loop;
  3. the first main path, with every launch counter set to 0 first: dd
     Rgemm C = alpha*A@B + beta*C at n = 4096 through rgemm on backend
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
     64) runs inside rgesv; the launch counts of phases 3-6;
  8. the second main path, counters set to 0 again: the upper rungs.  td
     and qd Rgemm at n = 2048 on pallas and ozaki-pallas, within
     16*k*ulp(tier) of each other; the td/qd Hilbert gates at n = 32 on both
     kernels (2^-150, 2^-190); the rgesv ladder receipt of
     tests/test_solve.py (Hilbert n = 26 formed in qd, target qd, backend
     ozaki-pallas: escalations exactly f64 -> dd -> td, no qd factor);
  9. the SDP interior-point solver on the card, backend pallas: SDPLIB
     theta1's shape (theta_problem(50, 0.085)) at binary128, held to the
     Table V receipts of tests/test_sdp.py (the primal infeasibility to
     the reference's own value on this problem), and at binary128+, whose
     gap must reach 1e-2 of it with the primal objective within 1e-18; the
     degenerate binary128+ receipt and the binary192 receipt of
     tests/test_sdp.py; then the launch counts of phases 8-9 (every
     td/qd instantiation must have run);
  10. the narrow path, counters set to 0 again: kernel #2 with bf16
     slices and f32 accumulation (csrc/ozgemm_narrow.cu, the pair dots on
     the tensor cores), through the entry points with the planner
     overrides slice_dtype="bfloat16", acc_dtype="float32": dd Rgemm at
     n = 4096 and td/qd at n = 2048 held to the pallas product (2^-90 at
     dd, the bound the reference's tests set for narrow plans; 16*k*ulp at
     td/qd), the tiny-rows operands of tests/test_ozgemm_kernel.py at dd,
     the Hilbert gates at every tier, the other narrow pairs (f32/f32,
     f16/f32, bf16/f64, f32/f64) through Rgemm at every tier, rgesv at
     n = 2048 (f64 factor, dd target; its residual through the fused
     drain), and
     solve_sdp on theta1's shape at binary128 (the batched Schur stacks on
     the narrow kernel) held to phase 9's gates, the gap to the
     reference's own value on this kernel, its history bit for bit
     against the reference's run eagerly (THETA1_NARROW_REF); then
     the launch counts of phase 10 (every narrow variant at every tier
     must have run);
  7. each kernel's time beside its bound: the dd kernels at 4096^3 (their
     plain versions there too, held bit for bit again), the td/qd kernels
     at 2048^3 (plain versions at 256^3), the narrow variants at the same
     shapes with the epilogue full (plain versions at 512^3 and 256^3, held
     bit for bit again) and the bf16/f32 dd one on the SDP stack; kernel
     #2 timed as one call, and its pre-pass and GEMM apart, its bound the
     larger of the pair dots on their unit (DMMA for f64 and f32/f64
     slices, the 16-bit tensor cores for bf16 and f16) and the f64 work; the elementwise kernels on the SDP's pairwise
     product, and (as context only: no PyTorch call computes a multi-limb
     GEMM) an f64 torch.matmul, or a bf16 one beside the narrow variants,
     at the same shapes;
  11. the autotuner on the card, once: autotune(2048, 2048, 2048,
     backend="ozaki-pallas") into the run's own plan cache, after which
     make_plan adopts the tuned entry and a narrow-override plan in the
     same bucket re-solves its slice count.

The port's plan cache points at a fresh file under build/ for the whole
run (REPRO_TORCH_GEMM_CACHE), so no tuned entry on the machine can change
the bits that the gates read.

The last two lines are a JSON object {"kernels": [...]} (the pre-pass's
rows, ozslice_dd/td/qd, among them) and
{"ok": true, "device": {...}}.  Without CUDA, or without the repository's
src/repro_torch beside it, the script exits non-zero and prints neither.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time
from fractions import Fraction
from pathlib import Path

U_DD = 2.0 ** -106
ULP = {"dd": 2.0 ** -104, "td": 2.0 ** -155, "qd": 2.0 ** -205}
NLIMBS = {"dd": 2, "td": 3, "qd": 4}

# H100 SXM peaks (NVIDIA's data sheet) for the bounds: 34 TFLOP/s f64
# outside the tensor cores counts an FMA as two flops, so the card runs
# 17e12 f64 instructions per second, a DADD, DMUL or DFMA being one each;
# the bounds count instructions against that rate.  And HBM3 bandwidth.
F64_PEAK = 34e12
F64_INSTR_PER_S = F64_PEAK / 2
# the f64 tensor cores (DMMA): 67 TFLOP/s, an FMA being two flops
DMMA_FMA_PER_S = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12
# f64 add/sub/mul operations per dd FMA in csrc/mlgemm.cu's inner loop
MLGEMM_OPS_PER_FMA = 51
# per operand element and slice in csrc/ozgemm.cu's extraction: the
# (hi + sigma) - sigma pair, the dd subtract (20) and the anchor step
OZGEMM_OPS_PER_SLICE = 23
ADD_FLOAT_OPS = 10      # dd.add_float, one fold per output per diagonal
DD_MUL_OPS, DD_ADD_OPS = 31, 20
# the dense bf16 (and f16) tensor-core rate of the H100 SXM (data sheet),
# for the 16-bit narrow variants' pair dots
BF16_TC_PEAK = 989e12
# per slice element in csrc/ozslice.cu's normalization (two DMULs), per
# output per diagonal in csrc/ozgemm_narrow.cu's rescale (two DMULs), and
# per output per slab its sc_a * sc_b (one)
NARROW_NORM_OPS, NARROW_RESCALE_OPS = 2, 2
# the narrow plans of phase 10: the TPU kernel's own configuration
NARROW = {"slice_dtype": "bfloat16", "acc_dtype": "float32"}
NARROW_PAIRS = (("bfloat16", "float32"), ("float32", "float32"),
                ("float16", "float32"), ("bfloat16", "float64"),
                ("float32", "float64"))
# the bound tests/test_ozgemm_kernel.py sets for narrow plans at dd
NARROW_DD_BOUND = 2.0 ** -90
# theta1's shape floors the primal infeasibility above the 1e-20 of
# tests/test_sdp.py's theta8 receipt: the reference itself, binary128
# solve_sdp on theta_problem(50, 0.085, seed=0) (CPU, backend xla, 80
# iterations, tools/sdp_reference.py), ends at pfeas 2.5688e-20 with gap
# 7.51e-22 and dfeas 2.77e-32, so the port is held to that value there
THETA1_REF_PFEAS = 2.5688e-20
# and on the narrow kernel the best of theta1's noisy iterates floors the
# gap above 1e-20.  The reference's narrow plan run eagerly, rounding op by
# op as the port does (tools/sdp_reference.py theta 50 0.085 0 --backend
# ozaki-pallas --slice-dtype bfloat16 --acc-dtype float32 --eager; its last
# line is this file), gives the history phase 10 holds the card's to, bit
# for bit, and the gap it holds the card's to: the reference's own best
THETA1_NARROW_REF = Path("tools") / "theta1_bf16_eager_reference.json"


# f64 operations of the k-limb recipes in csrc/ml_device.cuh (two_sum 6,
# products 1 each; the operand splits are left out, so the bound stays a
# least time)
def renorm_ops(n_terms, k):
    """renorm<K, N>: three sweeps of two two_sum passes, the tail adds, a
    final vecsum + compress over k."""
    return 3 * 2 * (n_terms - 1) * 6 + (n_terms - k) + 2 * (k - 1) * 6


def mul_ops(k):
    pairs = k * (k - 1) // 2
    return 5 * pairs + k + renorm_ops(5 * pairs + k, k)


def add_ops(k):
    return renorm_ops(2 * k, k)


def fma_ops(k):
    return MLGEMM_OPS_PER_FMA if k == 2 else mul_ops(k) + add_ops(k)


def tier_mul_ops(k):
    return DD_MUL_OPS if k == 2 else mul_ops(k)


def log(msg):
    print(msg, flush=True)


def headroom_operand(shape, beta, seed, device, p="dd"):
    """All-positive tier values in [1, 2) whose every slice digit (of the
    anchor ladder at slab depth 16) is 2^(beta-1) - 1 or one less: the
    largest all-positive digits round-to-nearest slicing leaves."""
    import numpy as np
    import torch
    from repro_torch.core import mp

    rng = np.random.default_rng(seed)
    top = 2 ** (beta - 1) - 1
    k = NLIMBS[p]
    n_digits = 1 + (53 * k - (beta - 1)) // beta  # what k f64 limbs hold
    limbs = [np.empty(shape) for _ in range(k)]
    for idx in np.ndindex(*shape):
        v = sum(Fraction(top - int(rng.integers(0, 2)) * (i > 0),
                         2 ** (i * beta)) for i in range(n_digits))
        v *= Fraction(2 ** 2, 2 ** beta)
        for l in limbs:
            l[idx] = float(v)
            v -= Fraction(l[idx])
    return mp.from_limbs([torch.as_tensor(l, device=device)
                          for l in limbs])


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def ptxas_summary(text):
    """[(kernel, registers, spill store bytes, spill load bytes)] from
    nvcc -Xptxas -v output."""
    out, name, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1))) + spill)
            name = None
    return out


def main() -> int:
    t_start = time.perf_counter()
    import numpy as np
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
    # the port's plan cache: a fresh file for this run only, so that no
    # tuned entry on the machine moves the bits the gates read
    plans = src.parent / "build" / "chip_smoke" / "plans.json"
    shutil.rmtree(plans.parent, ignore_errors=True)
    plans.parent.mkdir(parents=True)
    os.environ["REPRO_TORCH_GEMM_CACHE"] = str(plans)

    from repro_torch.core import dd, mp
    from repro_torch.core.accuracy import (GATES, hilbert_relative_error,
                                           hilbert_tier, max_rel_err)
    from repro_torch.core.blas import rgemm, rlange
    from repro_torch.core.linalg import apply_pivots, lu_solve, rgetrf
    from repro_torch.core.sdp import random_sdp, solve_sdp, theta_problem
    from repro_torch.core.ozaki import (_extract_slices, _normalize_slices,
                                        diagonal_sums, slice_params)
    from repro_torch.gemm import autotune, default_cache, make_plan, matmul
    from repro_torch.kernels import _build, mlgemm, mpops, ozgemm, ozslice
    from repro_torch.solve import rgesv

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(20230607)
    counters = {"mlgemm": mlgemm.launches, "ozgemm": ozgemm.launches,
                "ozslice": ozslice.launches, "mpops": mpops.launches}

    def reset_counts():
        for c in counters.values():
            for k in c:
                c[k] = 0
        ozgemm.launch_shapes.clear()

    def shape_counts():
        """Kernel #2's GEMM launches since the last reset, by (kernel,
        batch x m x k x n), most first."""
        return {f"{key} {'x'.join(map(str, shp))}": cnt for (key, shp), cnt
                in ozgemm.launch_shapes.most_common()}

    def read_counts():
        return {name: dict(c) for name, c in counters.items()}

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

    def rand_tier(shape, p):
        """A normalized tier value with signal in every limb."""
        x = mp.from_float(torch.randn(shape, generator=gen, device=dev,
                                      dtype=torch.float64), p)
        for i in range(1, NLIMBS[p]):
            x = mp.add(x, mp.from_float(torch.randn(
                shape, generator=gen, device=dev,
                dtype=torch.float64) * 2.0 ** (-53 * i), p))
        return x

    def scalar(num, den, p="dd"):
        one = mp.from_float(torch.tensor(float(num), dtype=torch.float64,
                                         device=dev), p)
        return mp.div(one, mp.from_float(torch.tensor(
            float(den), dtype=torch.float64, device=dev), p))

    # ---- 1. the card and the build -------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    logs, t_build = sync_time(_build.build_all)
    log(f"phase 1: built {', '.join(_build.SOURCES)} at limb counts "
        f"{_build.LIMBS} in {t_build:.2f} s ({len(logs)} nvcc processes; "
        f"nvcc {' '.join(_build.NVCC_FLAGS)} -DKLIMBS=k)")
    for (name, nl), text in sorted(logs.items()):
        for kern, regs, st, ld in ptxas_summary(text):
            log(f"phase 1: {name} k={nl} {kern}: {regs} registers, spill "
                f"stores {st} B, spill loads {ld} B")
            # kernel #2's GEMMs at dd, every slice variant
            check(not (nl == 2 and name.startswith("ozgemm")
                       and st + ld > 0),
                  f"{name} k={nl} {kern} spills {st} + {ld} B")
    # kernel #2's shared memory as the sources count it, against the
    # wrapper's count (which refuses what a block cannot hold)
    for nl in _build.LIMBS:
        for bk, ns in ((8, 3), (16, 5), (16, 15), (32, 24), (48, 7)):
            for (sdt, adt), v in ozgemm.SLICE_PAIRS.items():
                if v is None:
                    got = _build.load("ozgemm", nl).ozgemm_smem_bytes(bk, ns)
                else:
                    cv = ozslice.CUDA_VARIANT[v]  # f16/f32: f32/f32's build
                    got = _build.load("ozgemm_narrow", nl, cv) \
                        .ozgemm_narrow_smem_bytes(bk, ns, cv)
                check(got == ozgemm.smem_bytes(bk, ns, sdt, adt),
                      f"shared memory count {sdt}/{adt} bk={bk} "
                      f"n_slices={ns}: kernel {got} B, wrapper "
                      f"{ozgemm.smem_bytes(bk, ns, sdt, adt)} B")
    log("phase 1: kernel #2's shared-memory counts equal the wrapper's for "
        "every slice pair and limb count")

    # ---- 2. kernels against their plain versions, bit for bit ----------
    t2 = time.perf_counter()
    max_err = {}

    def compare(key, got_limbs, want):
        want_l = mp.limbs(want)
        err = max(float(torch.max(torch.abs(g - w))) if g.numel() else 0.0
                  for g, w in zip(got_limbs, want_l))
        same = all(g.shape == w.shape and torch.equal(g, w)
                   for g, w in zip(got_limbs, want_l))
        max_err[key] = max(max_err.get(key, 0.0), err)
        return same, err

    def hold(key, label, got_limbs, want):
        same, err = compare(key, got_limbs, want)
        log(f"phase 2: {key} {label} kernel == plain: {same} "
            f"(max abs diff {err:.3e})")
        check(same, f"{key} {label} differs from its plain version")

    def oz_operands(a, b, epi, alpha=None, beta=None, c=None):
        """The kernel's operand list and the plain version's epilogue
        keywords for one epilogue."""
        ops = [*mp.limbs(a), *mp.limbs(b)]
        kw = {}
        if epi != "none":
            ops += [l.reshape(1, 1) for l in mp.limbs(alpha)]
            kw["alpha"] = mp.map_limbs(lambda l: l.reshape(1, 1), alpha)
        if epi == "full":
            ops += [*[l.reshape(1, 1) for l in mp.limbs(beta)],
                    *mp.limbs(c)]
            kw.update(beta_s=mp.map_limbs(lambda l: l.reshape(1, 1), beta),
                      c=c)
        return ops, kw

    def oz_plan_kw(m, k, n, p, sdt="float64", adt="float64"):
        plan = make_plan(m, k, n, precision=p, backend="ozaki-pallas",
                         platform="cuda", slice_dtype=sdt, acc_dtype=adt)
        return plan, dict(bk=plan.bk, beta=plan.slice_beta,
                          n_slices=plan.n_slices, slice_dtype_name=sdt,
                          acc_dtype_name=adt)

    def oz_call(a, b, p, epi, alpha=None, beta=None, c=None):
        plan, pkw = oz_plan_kw(a.shape[-2], a.shape[-1], b.shape[-1], p)
        ops, kw = oz_operands(a, b, epi, alpha, beta, c)
        got = ozgemm.ozgemm_kernel_call(*ops, epilogue=epi, **pkw)
        want = ozgemm.ozgemm_plain(a, b, **kw, **pkw)
        return got, want, plan

    def narrow_name(p, sdt, adt):
        return (f"ozgemm_{p}_"
                f"{ozgemm.VARIANTS[ozgemm.SLICE_PAIRS[sdt, adt]]}"
                .replace("/", "-"))

    # kernel #1 at the shapes the main paths give it: dd as in the first
    # slice; td/qd square, ragged, the SDP's X @ (A_j Z^-1) stack with X
    # shared, and an rposv residual of the Schur system
    hil = hilbert_tier("dd", 32, device="cuda")
    dd_cases = [("512^3", rand_dd(512, 512), rand_dd(512, 512)),
                ("509x263x131", rand_dd(509, 263), rand_dd(263, 131)),
                ("Hilbert 32^3", hil, hil)]
    for label, a, b in dd_cases + [
            ("1984x64x1984", rand_dd(1984, 64), rand_dd(64, 1984)),
            ("2048x2048x4", rand_dd(2048, 2048), rand_dd(2048, 4))]:
        hold("mlgemm_dd", label,
             mlgemm.mlgemm_kernel_call(*mp.limbs(a), *mp.limbs(b)),
             mlgemm.mlgemm_plain(a, b))
    for p in ("td", "qd"):
        for label, a, b in [
                ("256^3", rand_tier((256, 256), p), rand_tier((256, 256), p)),
                ("509x263x131", rand_tier((509, 263), p),
                 rand_tier((263, 131), p)),
                ("SDP stack 104 x 50x50x50 (A shared)",
                 rand_tier((50, 50), p), rand_tier((104, 50, 50), p)),
                ("rposv residual 104x104x1", rand_tier((104, 104), p),
                 rand_tier((104, 1), p))]:
            hold(f"mlgemm_{p}", label,
                 mlgemm.mlgemm_kernel_call(*mp.limbs(a), *mp.limbs(b)),
                 mlgemm.mlgemm_plain(a, b))
    # kernel #2: dd as in the first slice, td/qd square and ragged, each
    # with the three epilogues, and one batched call per tier
    for p in ("dd", "td", "qd"):
        alpha, beta = scalar(1, 3, p), scalar(-1, 7, p)
        cases = dd_cases if p == "dd" else [
            ("256^3", rand_tier((256, 256), p), rand_tier((256, 256), p)),
            ("509x263x131", rand_tier((509, 263), p),
             rand_tier((263, 131), p))]
        for label, a, b in cases:
            c = rand_tier((a.shape[0], b.shape[1]), p)
            for epi in ozgemm.EPILOGUES:
                got, want, plan = oz_call(a, b, p, epi, alpha, beta, c)
                hold(f"ozgemm_{p}", f"{label} epilogue={epi} (bk={plan.bk},"
                     f" beta={plan.slice_beta}, n_slices={plan.n_slices})",
                     got, want)
        a, b = rand_tier((6, 96, 80), p), rand_tier((80, 72), p)
        c = rand_tier((6, 96, 72), p)
        for epi in ozgemm.EPILOGUES:
            got, want, _ = oz_call(a, b, p, epi, alpha, beta, c)
            hold(f"ozgemm_{p}", f"batched 6 x 96x80x72 (B shared) "
                 f"epilogue={epi}", got, want)
    # batched == looped, both kernels, every tier, through the engine
    for p in ("dd", "td", "qd"):
        a, b = rand_tier((5, 70, 40), p), rand_tier((5, 40, 66), p)
        for backend, key in (("pallas", "mlgemm"), ("ozaki-pallas",
                                                    "ozgemm")):
            got = matmul(a, b, backend=backend)
            same = all(
                all(torch.equal(g, w) for g, w in zip(
                    mp.limbs(got[i]),
                    mp.limbs(matmul(a[i], b[i], backend=backend))))
                for i in range(5))
            log(f"phase 2: {key}_{p} batched 5 x 70x40x66 == looped: {same}")
            check(same, f"{key}_{p} batched differs from looped")
    # kernel #2's narrow variants (csrc/ozgemm_narrow.cu), every slice pair
    # at every tier: the ragged shape, the Hilbert gate's 32^3 and an
    # rgesv residual, each epilogue drained from one plain accumulator
    # (ozgemm_plain's own drain, apply_epilogue on the tier module)
    for p in ("dd", "td", "qd"):
        alpha, beta = scalar(1, 3, p), scalar(-1, 7, p)
        hil_p = hil if p == "dd" else hilbert_tier(p, 32, device="cuda")
        for label, a, b in [
                ("509x263x131", rand_tier((509, 263), p),
                 rand_tier((263, 131), p)),
                ("Hilbert 32^3", hil_p, hil_p),
                ("2048x2048x4", rand_tier((2048, 2048), p),
                 rand_tier((2048, 4), p))]:
            m, k = a.shape
            n = b.shape[1]
            c = rand_tier((m, n), p)
            for sdt, adt in NARROW_PAIRS:
                plan, pkw = oz_plan_kw(m, k, n, p, sdt, adt)
                acc = ozgemm.ozgemm_plain(a, b, **pkw)
                for epi in ozgemm.EPILOGUES:
                    ops, kw = oz_operands(a, b, epi, alpha, beta, c)
                    want = ozgemm.apply_epilogue(
                        acc, kw.get("alpha"), kw.get("beta_s"), kw.get("c"),
                        ops=mp.tier_module(acc))
                    hold(narrow_name(p, sdt, adt),
                         f"{label} epilogue={epi} (bk={plan.bk}, beta="
                         f"{plan.slice_beta}, n_slices={plan.n_slices})",
                         ozgemm.ozgemm_kernel_call(*ops, epilogue=epi,
                                                   **pkw), want)
        # the batched instantiations: the SDP's X @ (A_j Z^-1) stack with X
        # shared (the shape of phase 10's Schur stacks), and a B-shared
        # batch with the three epilogues, each against its own plain call
        stack = [("SDP stack 99 x 50x50x50 (A shared)",
                  rand_tier((50, 50), p), rand_tier((99, 50, 50), p), None),
                 ("batched 6 x 96x80x72 (B shared)",
                  rand_tier((6, 96, 80), p), rand_tier((80, 72), p),
                  rand_tier((6, 96, 72), p))]
        for label, a, b, c in stack:
            m, k = a.shape[-2:]
            n = b.shape[-1]
            for sdt, adt in NARROW_PAIRS:
                plan, pkw = oz_plan_kw(m, k, n, p, sdt, adt)
                for epi in ozgemm.EPILOGUES if c is not None else ("none",):
                    ops, kw = oz_operands(a, b, epi, alpha, beta, c)
                    hold(narrow_name(p, sdt, adt),
                         f"{label} epilogue={epi} (bk={plan.bk}, beta="
                         f"{plan.slice_beta}, n_slices={plan.n_slices})",
                         ozgemm.ozgemm_kernel_call(*ops, epilogue=epi,
                                                   **pkw),
                         ozgemm.ozgemm_plain(a, b, **kw, **pkw))
        a, b = rand_tier((5, 70, 40), p), rand_tier((5, 40, 66), p)
        for sdt, adt in NARROW_PAIRS:
            kw = dict(backend="ozaki-pallas", slice_dtype=sdt, acc_dtype=adt)
            got = matmul(a, b, **kw)
            same = all(all(torch.equal(g, w) for g, w in zip(
                mp.limbs(got[i]), mp.limbs(matmul(a[i], b[i], **kw))))
                for i in range(5))
            log(f"phase 2: {narrow_name(p, sdt, adt)} batched 5 x 70x40x66 "
                f"== looped: {same}")
            check(same, f"{narrow_name(p, sdt, adt)} batched differs from "
                  f"looped")
    # the adversarial headroom case: every slice digit at its largest, so
    # the f32 diagonal sums reach past 2^23 grid units of their 24 bits
    # (a normalized bf16 slice is an integer times 2^-beta);
    # the kernel equals the plain version, and the plain version's f32
    # sums equal the same slice dots in f64, where they are exact
    a = headroom_operand((128, 64), 8, 1, dev)
    b = headroom_operand((64, 128), 8, 2, dev)
    plan, pkw = oz_plan_kw(128, 64, 128, "dd", *NARROW_PAIRS[0])
    check((plan.bk, plan.slice_beta, plan.n_slices) == (16, 8, 15),
          f"the headroom case's plan {plan}")
    hold(narrow_name("dd", *NARROW_PAIRS[0]), "headroom 128x64x128 "
         "(digits 2^(beta-1) - 1)",
         ozgemm.ozgemm_kernel_call(*mp.limbs(a), *mp.limbs(b), **pkw),
         ozgemm.ozgemm_plain(a, b, **pkw))
    top, tier = 0.0, mp.tier_module(a)
    for k0 in range(0, 64, 16):
        sa = _extract_slices(a[:, k0:k0 + 16], 8, 15, axis=-1, ops=tier)
        sb = _extract_slices(b[k0:k0 + 16, :], 8, 15, axis=-2, ops=tier)
        sa, _ = _normalize_slices(sa, 8, -1, torch.bfloat16)
        sb, _ = _normalize_slices(sb, 8, -2, torch.bfloat16)
        for (d, f32), (_, f64) in zip(
                diagonal_sums(sa, sb, 15, False, torch.float32),
                diagonal_sums(sa, sb, 15, False, torch.float64)):
            check(torch.equal(f32.to(torch.float64), f64),
                  f"headroom diagonal {d} of slab {k0 // 16}: the f32 sum "
                  f"is not the exact one")
            top = max(top, float(f64.abs().max()) * 2.0 ** 16)
    log(f"phase 2: headroom case: every f32 diagonal sum equals its f64 "
        f"(exact) value; largest {top:.0f} grid units = "
        f"2^{torch.log2(torch.tensor(top)).item():.2f} of the 2^24 headroom")
    check(top > 2 ** 23, "the headroom case did not fill the f32 sums")
    # kernel #2's pre-pass (csrc/ozslice.cu) on the operands phase 2 gives
    # the GEMMs, every slice type at every tier: slices and scales bit for
    # bit; then the K-panel path, a one-byte workspace budget walking K one
    # slab per panel (the accumulator carried in the output), against the
    # plain version in one panel
    def hold_ws(key, label, got, want):
        same = all((g is None and w is None) or (
            g.shape == w.shape and torch.equal(g, w))
            for g, w in zip(got, want))
        err = float(torch.max(torch.abs(got[0].double() - want[0].double())))
        max_err[key] = max(max_err.get(key, 0.0), err)
        log(f"phase 2: {key} {label} kernel == plain: {same} (max abs diff "
            f"{err:.3e})")
        check(same, f"{key} {label} differs from its plain version")

    for p in ("dd", "td", "qd"):
        alpha, beta = scalar(1, 3, p), scalar(-1, 7, p)
        for label, a, b, c in [
                ("509x263x131", rand_tier((509, 263), p),
                 rand_tier((263, 131), p), rand_tier((509, 131), p)),
                ("SDP stack 99 x 50x50x50 (A shared)", rand_tier((50, 50), p),
                 rand_tier((99, 50, 50), p), None),
                ("batched 6 x 96x80x72 (B shared)", rand_tier((6, 96, 80), p),
                 rand_tier((80, 72), p), rand_tier((6, 96, 72), p))]:
            m, k = a.shape[-2:]
            n = b.shape[-1]
            for (sdt, adt), v in ozgemm.SLICE_PAIRS.items():
                plan, pkw = oz_plan_kw(m, k, n, p, sdt, adt)
                kw = dict(bk=plan.bk, beta=plan.slice_beta,
                          n_slices=plan.n_slices, variant=v)
                for x, rows, what in ((a, True, "A"), (b, False, "B")):
                    hold_ws(f"ozslice_{p}", f"{label} {what} {sdt}/{adt} "
                            f"(bk={plan.bk}, n_slices={plan.n_slices})",
                            ozslice.ozslice_call(mp.limbs(x), rows=rows,
                                                 **kw),
                            ozslice.ozslice_plain(x, rows=rows, **kw))
                epi = "none" if c is None else "full"
                ops, ekw = oz_operands(a, b, epi, alpha, beta, c)
                hold(f"ozgemm_{p}" if v is None else narrow_name(p, sdt, adt),
                     f"{label} K panels of one slab ({-(-k // plan.bk)}) "
                     f"epilogue={epi}",
                     ozgemm.ozgemm_kernel_call(*ops, epilogue=epi,
                                               workspace_bytes=1, **pkw),
                     ozgemm.ozgemm_plain(a, b, **ekw, **pkw))
    # the f64 adversarial headroom case on the DMMA kernel: every slice
    # digit at its largest, so the f64 diagonal sums come as near their 53
    # bits as slicing lets them (dd: 2*beta + 4 + 3 = 53; qd: 52); the
    # kernel equals the plain version, and the plain version's f64 sums
    # equal the same slice dots summed on the host with a 64-bit
    # significand (np.longdouble), where they are exact
    for p in ("dd", "qd"):
        plan, pkw = oz_plan_kw(128, 64, 128, p)
        bt, ns = plan.slice_beta, plan.n_slices
        check(plan.bk == 16, f"the f64 headroom case's plan {plan}")
        a = headroom_operand((128, 64), bt, 1, dev, p)
        b = headroom_operand((64, 128), bt, 2, dev, p)
        hold(f"ozgemm_{p}", f"headroom 128x64x128 on DMMA (digits "
             f"2^(beta-1) - 1, beta={bt}, n_slices={ns})",
             ozgemm.ozgemm_kernel_call(*mp.limbs(a), *mp.limbs(b), **pkw),
             ozgemm.ozgemm_plain(a, b, **pkw))
        sk = dict(bk=16, beta=bt, n_slices=ns)
        wa, _ = ozslice.ozslice_plain(a, rows=True, **sk)
        wb, _ = ozslice.ozslice_plain(b, rows=False, **sk)
        top = 0.0
        for j in range(4):
            sa = [wa[0, j, i] for i in range(ns)]
            sb = [wb[0, j, i].T for i in range(ns)]
            ha = [x.cpu().numpy().astype(np.longdouble) for x in sa]
            hb = [x.cpu().numpy().astype(np.longdouble) for x in sb]
            for d, f64 in diagonal_sums(sa, sb, ns, False, torch.float64):
                exact = sum(ha[i] @ hb[d - i]
                            for i in range(max(0, d - ns + 1),
                                           min(d, ns - 1) + 1))
                check(np.array_equal(
                    f64.cpu().numpy().astype(np.longdouble), exact),
                      f"{p} f64 headroom diagonal {d} of slab {j}: the f64 "
                      f"sum is not the exact one")
                # grid units: slice 0 of [1, 2) sits on 2^(1-beta)
                top = max(top, float(np.abs(exact).max())
                          * 2.0 ** (2 * bt - 2 + d * bt))
        log(f"phase 2: f64 headroom case {p}: every f64 diagonal sum equals "
            f"its exact value; largest {top:.0f} grid units = "
            f"2^{np.log2(top):.2f} of the 2^53 headroom")
        check(top > 2 ** 50, f"the {p} headroom case did not fill the f64 "
              f"sums")
    # the same on the narrow kernel's tensor-core routes, the plan pinned
    # or the planner's: f32/f32 at beta 9 on the f16 MMA (the bf16 plans
    # stop at 8), bf16/f64 at td (21 pairs on a diagonal: past 2^24 grid
    # units, so the kernel's f32 groups of 16 MMA results must close into
    # the f64 sum before the diagonal ends), f32/f64 on DMMA at dd (near
    # 2^53).  A normalized slice is an integer times 2^-beta, so a
    # diagonal's grid unit is 2^(-2 beta).  Each: kernel == plain, and the
    # plain version's sums in its accumulator == the same dots summed
    # exactly on the host
    for p, (sdt, adt), pin, floor in (
            ("dd", ("float32", "float32"), dict(bk=16, beta=9, n_slices=4),
             2 ** 23),
            ("td", ("bfloat16", "float64"), None, 2 ** 24),
            ("dd", ("float32", "float64"), None, 2 ** 51)):
        if pin is None:
            plan, pkw = oz_plan_kw(128, 64, 128, p, sdt, adt)
            pin = dict(bk=plan.bk, beta=plan.slice_beta,
                       n_slices=plan.n_slices)
        pkw = dict(pin, slice_dtype_name=sdt, acc_dtype_name=adt)
        bt, ns, v = pin["beta"], pin["n_slices"], ozgemm.SLICE_PAIRS[sdt, adt]
        check(pin["bk"] == 16, f"the {sdt}/{adt} headroom case's plan {pin}")
        a = headroom_operand((128, 64), bt, 1, dev, p)
        b = headroom_operand((64, 128), bt, 2, dev, p)
        name = narrow_name(p, sdt, adt)
        hold(name, f"headroom 128x64x128 (digits 2^(beta-1) - 1, beta={bt}, "
             f"n_slices={ns})",
             ozgemm.ozgemm_kernel_call(*mp.limbs(a), *mp.limbs(b), **pkw),
             ozgemm.ozgemm_plain(a, b, **pkw))
        sk = dict(bk=16, beta=bt, n_slices=ns, variant=v)
        wa, _ = ozslice.ozslice_plain(a, rows=True, **sk)
        wb, _ = ozslice.ozslice_plain(b, rows=False, **sk)
        top, one_f32 = 0.0, True
        for j in range(4):
            sa = [wa[0, j, i] for i in range(ns)]
            sb = [wb[0, j, i].T for i in range(ns)]
            ha = [x.cpu().double().numpy().astype(np.longdouble) for x in sa]
            hb = [x.cpu().double().numpy().astype(np.longdouble) for x in sb]
            f32 = dict(diagonal_sums(sa, sb, ns, False, torch.float32))
            for d, dsum in diagonal_sums(sa, sb, ns, False,
                                         getattr(torch, adt)):
                exact = sum(ha[i] @ hb[d - i]
                            for i in range(max(0, d - ns + 1),
                                           min(d, ns - 1) + 1))
                check(np.array_equal(
                    dsum.cpu().double().numpy().astype(np.longdouble),
                    exact), f"{name} headroom diagonal {d} of slab {j}: the "
                    f"{adt} sum is not the exact one")
                one_f32 &= np.array_equal(
                    f32[d].cpu().double().numpy().astype(np.longdouble),
                    exact)
                top = max(top, float(np.abs(exact).max()) * 2.0 ** (2 * bt))
        ctx = "" if adt == "float32" else (
            f" (one f32 sum per diagonal, as context: "
            f"{'exact' if one_f32 else 'rounded'} on these digits)")
        log(f"phase 2: {name} headroom case: every {adt} diagonal sum equals "
            f"its exact value; largest {top:.0f} grid units = "
            f"2^{np.log2(top):.2f}{ctx}")
        check(top > floor, f"the {name} headroom case did not reach "
              f"2^{np.log2(floor):.0f} grid units")
    # the elementwise kernels on the SDP loop's shapes: a Cholesky column
    # (div by a broadcast pivot), a triangular-solve row (a broadcast row
    # times a block), the pairwise product (4-D broadcast), the sums
    m_sdp, n_sdp = 99, 50
    for p in ("dd", "td", "qd"):
        key = f"mpops_{p}"
        col, piv = rand_tier((49, 1), p), rand_tier((1, 1), p)
        row, blk = rand_tier((30, 1), p), rand_tier((30, 4950), p)
        st_a = rand_tier((m_sdp, 1, n_sdp, n_sdp), p)
        st_v = mp.map_limbs(lambda l: l.transpose(-1, -2),
                            rand_tier((1, m_sdp, n_sdp, n_sdp), p))
        pos = mp.abs_(rand_tier((1, 1), p))
        for label, op, args in [
                ("div (49,1)/(1,1)", "div", (col, piv)),
                ("sqrt (1,1)", "sqrt", (pos,)),
                ("mul (30,1)x(30,4950)", "mul", (row, blk)),
                ("sub (30,4950)", "sub", (blk, rand_tier((30, 4950), p))),
                ("fma (49,1)", "fma", (col, col, piv)),
                ("mul_float (30,4950)", "mul_float",
                 (blk, mp.limbs(row)[0])),
                (f"mul ({m_sdp},1,{n_sdp},{n_sdp})x(1,{m_sdp},..)^T", "mul",
                 (st_a, st_v))]:
            hold(key, label, mp.limbs(mpops.mpops_call(op, *args)),
                 mpops.mpops_plain(op, *args))
        prod = mpops.mpops_call("mul", st_a, st_v).reshape(m_sdp, m_sdp, -1)
        hold(key, f"sum ({m_sdp},{m_sdp},{n_sdp * n_sdp}) axis 2",
             mp.limbs(mpops.sum_(prod, axis=2)),
             mpops.sum_plain(prod, axis=2))
        hold(key, "sum (30,4950) axis 0", mp.limbs(mpops.sum_(blk, axis=0)),
             mpops.sum_plain(blk, axis=0))
        del prod, st_a, st_v
    log(f"phase 2: {time.perf_counter() - t2:.1f} s")

    # ---- 3. the first main path: dd Rgemm at n = 4096 ------------------
    reset_counts()
    n = 4096
    A, B, C = rand_dd(n, n), rand_dd(n, n), rand_dd(n, n)
    alpha, beta = scalar(1, 3), scalar(-1, 7)
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
        f"16*k*2^-104 = {16 * n * ULP['dd']:.3e})")
    check(err <= 16 * n * ULP["dd"], "the two Rgemm backends disagree")
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
    resid = mp.sub(apply_pivots(A, piv), matmul(low, up, backend="pallas"))
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
    path1 = read_counts()
    log(f"phase 3-6: kernel launches on the first main path: {path1}")
    log(f"phase 3-6: kernel #2's GEMM launches by shape: {shape_counts()}")
    check(path1["mlgemm"][2] > 0 and path1["ozgemm"][2] > 0
          and path1["mpops"][2] > 0,
          "a dd kernel of the first main path never launched")
    del A, a64, b64, q, ill, bi, x

    # ---- 8. the second main path: the upper rungs ----------------------
    reset_counts()
    t8 = time.perf_counter()
    n = 2048
    for p in ("td", "qd"):
        A, B, C = (rand_tier((n, n), p) for _ in range(3))
        alpha, beta = scalar(1, 3, p), scalar(-1, 7, p)
        outs = {}
        for backend in ("ozaki-pallas", "pallas"):
            outs[backend], t = sync_time(lambda: rgemm(
                "n", "n", alpha, A, B, beta, C, backend=backend))
            log(f"phase 8: rgemm {p} n={n} backend={backend}: {t:.4f} s")
        err = max_rel_err(outs["ozaki-pallas"], outs["pallas"])
        log(f"phase 8: {p} max_rel_err(ozaki-pallas, pallas) = {err:.3e} "
            f"(bound 16*k*ulp_{p} = {16 * n * ULP[p]:.3e})")
        check(err <= 16 * n * ULP[p], f"the two {p} Rgemm backends disagree")
        check(all(bool(torch.isfinite(l).all()) for o in outs.values()
                  for l in mp.limbs(o)), f"non-finite {p} Rgemm output")
        del outs, A, B, C
        for backend in ("pallas", "ozaki-pallas"):
            err, t = sync_time(lambda: hilbert_relative_error(
                p, 32, backend, device="cuda"))
            log(f"phase 8: Hilbert n=32 {p} {backend}: rel err {err:.3e} "
                f"(gate {GATES[p]:.3e}) in {t:.2f} s")
            check(err <= GATES[p], f"{p} Hilbert gate on {backend}")
    # the td rung's receipt: cond ~1e38 between dd's and td's reach
    h = hilbert_tier("qd", 26, device="cuda")
    bh = matmul(h, mp.from_float(torch.ones(26, 1, dtype=torch.float64,
                                            device=dev), "qd"),
                backend="ozaki-pallas")
    (x, info), t = sync_time(lambda: rgesv(
        h, bh, target_tier="qd", backend="ozaki-pallas", max_iters=40))
    esc = [(e["from"], e["to"]) for e in info.escalations]
    log(f"phase 8: rgesv Hilbert n=26 (qd) target qd ozaki-pallas: "
        f"{t:.2f} s, converged={info.converged} in {info.iterations} "
        f"iterations, escalations {esc}, factorizations "
        f"{info.factorizations}, final backward error "
        f"{info.final_backward_error:.3e}")
    check(info.converged and esc == [("f64", "dd"), ("dd", "td")]
          and "qd" not in info.factorizations
          and info.factor_tiers[-1] == "td",
          "the Hilbert n=26 ladder receipt")
    log(f"phase 8: {time.perf_counter() - t8:.1f} s")

    # ---- 9. the SDP interior-point solver on the card ------------------
    t9 = time.perf_counter()
    sdp_runs = {}

    def run_sdp(label, prob, gemm=None, **kw):
        res, t = sync_time(lambda: solve_sdp(
            prob, gemm_overrides=gemm or {"backend": "pallas"}, **kw))
        best = min(res.history, key=lambda h: h[1])
        log(f"phase 9: {label}: {res.iterations} iterations, gap "
            f"{res.relative_gap!r} (iteration {best[0]}), pfeas "
            f"{res.p_feas_err:.3e}, dfeas {res.d_feas_err:.3e}, primal "
            f"{res.primal_obj!r}, converged {res.converged}, schur_stats "
            f"{res.schur_stats}, {t:.1f} s ({t / res.iterations:.3f} s per "
            f"iteration)")
        sdp_runs[label] = {"iterations": res.iterations,
                           "gap": res.relative_gap, "best_iteration": best[0],
                           "seconds": t}
        return res

    theta = theta_problem(50, edge_prob=0.085, seed=0)
    log(f"phase 9: theta_problem(50, 0.085, seed=0): n={theta.n}, "
        f"m={theta.m} (SDPLIB theta1: n=50, m=104)")
    r128 = run_sdp("theta1 shape binary128", theta, precision="binary128",
                   max_iters=80)
    # the Table V receipts of tests/test_sdp.py, pfeas at the reference's
    # own value on this problem
    log(f"phase 9: gates gap < 1e-20, pfeas <= {THETA1_REF_PFEAS:.4e} (the "
        f"reference's), dfeas < 1e-28")
    check(r128.relative_gap < 1e-20 and r128.p_feas_err <= THETA1_REF_PFEAS
          and r128.d_feas_err < 1e-28, "theta1 binary128 Table V receipts")
    rqd = run_sdp("theta1 shape binary128+", theta, precision="binary128+",
                  max_iters=90)
    rel_obj = abs(rqd.primal_obj - r128.primal_obj) / abs(r128.primal_obj)
    log(f"phase 9: binary128+ gap / binary128 gap = "
        f"{rqd.relative_gap / r128.relative_gap:.3e} (gate 1e-2); primal "
        f"objectives agree to {rel_obj:.3e} relative (gate 1e-18)")
    check(rqd.relative_gap <= 1e-2 * r128.relative_gap and rel_obj <= 1e-18,
          "theta1 binary128+ against binary128")
    deg = run_sdp("random_sdp(6, 4, seed=3, degeneracy=1e-5) binary128+",
                  random_sdp(6, 4, seed=3, degeneracy=1e-5),
                  precision="binary128+", max_iters=90, tol_gap=1e-26)
    st = deg.schur_stats
    check(deg.relative_gap <= 1e-20
          and st["factorizations"].get("qd", 0) < st["solves"] // 2,
          "the degenerate binary128+ receipt")
    prob = random_sdp(6, 4, seed=3)
    rtd = run_sdp("random_sdp(6, 4, seed=3) binary192", prob,
                  precision="binary192", max_iters=50, tol_gap=1e-18)
    check(rtd.converged and rtd.relative_gap <= 1e-18
          and abs(rtd.primal_obj - prob.opt) < 1e-8 * max(1, abs(prob.opt)),
          "the binary192 receipt")
    log(f"phase 9: {time.perf_counter() - t9:.1f} s")
    path2 = read_counts()
    log(f"phase 8-9: kernel launches on the second main path: {path2}")
    log(f"phase 8-9: kernel #2's GEMM launches by shape: {shape_counts()}")
    check(all(path2[name][k] > 0 for name in counters for k in (3, 4)),
          "a td/qd kernel of the second main path never launched")

    # ---- 10. the narrow path: kernel #2 with bf16 slices -----------------
    reset_counts()
    t10 = time.perf_counter()
    narrow_runs = {}

    def rel_to_max(got, want):
        """max |got - want| / max |want| (max_rel_err caps the scale below
        at 1, which says nothing for the tiny-rows product)."""
        diff = torch.abs(mp.to_float(mp.sub(got, want)))
        return float(torch.max(diff)) / float(
            torch.max(torch.abs(mp.to_float(want))))

    for p, n in (("dd", 4096), ("td", 2048), ("qd", 2048)):
        A, B, C = (rand_tier((n, n), p) for _ in range(3))
        alpha, beta = scalar(1, 3, p), scalar(-1, 7, p)
        got, t = sync_time(lambda: rgemm(
            "n", "n", alpha, A, B, beta, C, backend="ozaki-pallas",
            **NARROW))
        want = rgemm("n", "n", alpha, A, B, beta, C, backend="pallas")
        err = max_rel_err(got, want)
        gate = NARROW_DD_BOUND if p == "dd" else 16 * n * ULP[p]
        log(f"phase 10: rgemm {p} n={n} ozaki-pallas bf16/f32: {t:.4f} s, "
            f"{2 * n ** 3 / t / 1e12:.4f} TFLOP/s (2mnk/s); max_rel_err "
            f"against pallas {err:.3e} (gate {gate:.3e})")
        check(err <= gate and all(bool(torch.isfinite(l).all())
                                  for l in mp.limbs(got)),
              f"the narrow {p} Rgemm against pallas")
        narrow_runs[f"rgemm_{p}_n{n}"] = {"seconds": t,
                                          "tflops": 2 * n ** 3 / t / 1e12}
        del A, B, C, got, want
        err = hilbert_relative_error(p, 32, "ozaki-pallas", device="cuda",
                                     **NARROW)
        log(f"phase 10: Hilbert n=32 {p} ozaki-pallas bf16/f32: rel err "
            f"{err:.3e} (gate {GATES[p]:.3e})")
        check(err <= GATES[p], f"{p} Hilbert gate on the narrow kernel")
    # the tiny-rows operands of tests/test_ozgemm_kernel.py, at 1024^3
    n = 1024
    At = dd.from_float(torch.randn(n, n, generator=gen, device=dev,
                                   dtype=torch.float64) * 1e-30)
    Bt = dd.from_float(torch.randn(n, n, generator=gen, device=dev,
                                   dtype=torch.float64) * 1e25)
    err = rel_to_max(matmul(At, Bt, backend="ozaki-pallas", **NARROW),
                     matmul(At, Bt, backend="pallas"))
    log(f"phase 10: tiny rows (A x 1e-30, B x 1e25) dd n={n} bf16/f32: "
        f"error {err:.3e} of the largest entry (gate "
        f"{NARROW_DD_BOUND:.3e})")
    check(err <= NARROW_DD_BOUND, "the narrow kernel on tiny rows")
    # the other narrow pairs through Rgemm at every tier
    for p, n in (("dd", 1024), ("td", 512), ("qd", 512)):
        A, B, C = (rand_tier((n, n), p) for _ in range(3))
        alpha, beta = scalar(1, 3, p), scalar(-1, 7, p)
        want = rgemm("n", "n", alpha, A, B, beta, C, backend="pallas")
        gate = NARROW_DD_BOUND if p == "dd" else 16 * n * ULP[p]
        for sdt, adt in NARROW_PAIRS[1:]:
            got = rgemm("n", "n", alpha, A, B, beta, C,
                        backend="ozaki-pallas", slice_dtype=sdt,
                        acc_dtype=adt)
            err = max_rel_err(got, want)
            log(f"phase 10: rgemm {p} n={n} ozaki-pallas {sdt}/{adt}: "
                f"max_rel_err against pallas {err:.3e} (gate {gate:.3e})")
            check(err <= gate, f"the {sdt}/{adt} {p} Rgemm against pallas")
    # the refined solve: its residual through the fused drain
    n = 2048
    a64 = torch.randn(n, n, generator=gen, device=dev, dtype=torch.float64)
    b64 = a64 @ torch.randn(n, 4, generator=gen, device=dev,
                            dtype=torch.float64)
    (x, info), t = sync_time(lambda: rgesv(
        a64, b64, factor_tier="f64", target_tier="dd",
        backend="ozaki-pallas", **NARROW))
    log(f"phase 10: rgesv n={n} nrhs=4 f64->dd ozaki-pallas bf16/f32: "
        f"{t:.2f} s, converged={info.converged} in {info.iterations} "
        f"iterations, backward errors "
        f"{[f'{e:.2e}' for e in info.backward_errors]} (gate 4 n u_dd = "
        f"{4 * n * U_DD:.3e})")
    check(info.converged and info.final_backward_error <= 4 * n * U_DD,
          "the narrow rgesv did not converge to 4 n u_dd")
    narrow_runs["rgesv_n2048"] = {"seconds": t,
                                  "iterations": info.iterations}
    del a64, b64, x
    r10 = run_sdp("theta1 shape binary128, ozaki-pallas bf16/f32", theta,
                  gemm={"backend": "ozaki-pallas", **NARROW},
                  precision="binary128", max_iters=80)
    ref = json.loads((src.parent / THETA1_NARROW_REF).read_text())
    hist = [[float(v) for v in h] for h in r10.history]
    same = next((i for i, (h, w) in enumerate(zip(hist, ref["history"]))
                 if h != w), min(len(hist), len(ref["history"])))
    log(f"phase 10: the history (gap, pfeas, dfeas, mu per iteration) "
        f"equals the eager reference's ({THETA1_NARROW_REF}, "
        f"{ref['iterations']} iterations) bit for bit over its first "
        f"{same}")
    check(same == len(ref["history"]),
          f"theta1 on the narrow kernel left the eager reference's history "
          f"at iteration {same + 1} of its {len(ref['history'])}")
    log(f"phase 10: gates gap <= {ref['gap']!r} (the eager reference's "
        f"best), pfeas <= {THETA1_REF_PFEAS:.4e}, dfeas < 1e-28")
    check(r10.relative_gap <= ref["gap"]
          and r10.p_feas_err <= THETA1_REF_PFEAS and r10.d_feas_err < 1e-28,
          "theta1 binary128 on the narrow kernel: Table V receipts")
    narrow_runs["sdp_theta1_binary128"] = sdp_runs.pop(
        "theta1 shape binary128, ozaki-pallas bf16/f32")
    # the whole history at full precision, to set beside later references
    narrow_runs["sdp_theta1_binary128"]["history"] = hist
    log(f"phase 10: {time.perf_counter() - t10:.1f} s")
    path10 = read_counts()
    stack_counts = dict(ozgemm.launch_shapes)
    log(f"phase 10: kernel launches on the narrow path: {path10}")
    log(f"phase 10: kernel #2's GEMM launches by shape: {shape_counts()}")
    check(all(path10["ozgemm"][nl, v] > 0 for nl in _build.LIMBS
              for v in ozgemm.VARIANTS.values()),
          "a narrow variant of kernel #2 never launched on its path")

    # ---- 7. times beside bounds ----------------------------------------
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

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / F64_INSTR_PER_S, nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, \
            "operations" if t_ops >= t_bytes else "bytes"

    def pairs(s):
        return sum(len(range(max(0, d - s + 1), min(d + 1, s)))
                   for d in range(s))

    kernels = []

    def record(name, source, replaces, ms, plain_ms, b, shape, f64_ms,
               note="", launches=None, extra=None):
        key = name.split("_")[0]
        k = NLIMBS[name.split("_")[1]]
        if extra is None:
            extra = {"context_f64_matmul_ms": f64_ms}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": path1[key][k] + path2[key][k] if launches is None
            else launches,
            "max_abs_err": max_err.get(name.replace("_sdp_stack", ""), 0.0),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
            "bound_by": b[1], "library_ms": None, "shape": shape, **extra})
        ctx = "".join(f"; {c[8:-3].replace('_', ' ')} (context only) "
                      f"{v:.3f} ms" for c, v in extra.items()
                      if c.startswith("context_"))
        log(f"phase 7: {name} at {shape}: {ms:.2f} ms (bound {b[0]:.2f} ms "
            f"by {b[1]}, {b[0] / ms:.1%} of it), plain version "
            f"{plain_ms:.1f} ms{note}{ctx}")

    ml_src, ml_rep = ("src/repro_torch/csrc/mlgemm.cu",
                      "src/repro/kernels/mlgemm.py:90")
    oz_src, oz_rep = ("src/repro_torch/csrc/ozgemm.cu",
                      "src/repro/kernels/ozgemm.py:170")
    nz_src, nz_rep = ("src/repro_torch/csrc/ozgemm_narrow.cu",
                      "src/repro/kernels/ozgemm.py:78")
    sl_src, sl_rep = ("src/repro_torch/csrc/ozslice.cu",
                      "src/repro/kernels/ozgemm.py:81")

    def oz_times(a, b, ops, pkw, reps):
        """Kernel #2 at one shape, epilogue full: (one call, the pre-pass of
        both operands, the GEMM alone) in ms."""
        v = ozgemm.SLICE_PAIRS[pkw["slice_dtype_name"],
                               pkw["acc_dtype_name"]]
        kw = dict(bk=pkw["bk"], beta=pkw["beta"], n_slices=pkw["n_slices"],
                  variant=v)
        nl = len(mp.limbs(a))
        la, lb = list(mp.limbs(a)), list(mp.limbs(b))

        def prepass():
            return (ozslice.ozslice_call(la, rows=True, **kw),
                    ozslice.ozslice_call(lb, rows=False, **kw))

        one = event_ms(lambda: ozgemm.ozgemm_kernel_call(
            *ops, epilogue="full", **pkw), reps)
        pre = event_ms(prepass, reps)
        ws = prepass()
        _, _, alpha_l, beta_l, c_l = ozgemm._split_operands(ops, "full")[1:]
        gemm = event_ms(lambda: ozgemm._launch(
            nl, la, lb, alpha_l, beta_l, c_l, None, bk=kw["bk"],
            beta=kw["beta"], n_slices=kw["n_slices"], n_diag=kw["n_slices"],
            epi="full", variant=v, workspaces=ws), reps)
        del ws
        return one, pre, gemm

    def oz_bound(n, k, plan, sdt, adt):
        """Kernel #2's least time at n^3, epilogue full: the larger of the
        pair dots on their unit and the f64 work (the pre-pass's
        extraction, normalization, rescale, folds, epilogue) or the bytes;
        returns (bound, by, dots ms, f64 ms)."""
        s_n, mnk = plan.n_slices, n ** 3
        dots = mnk * pairs(s_n)  # multiply-adds of the pair dots
        narrow = sdt != "float64"
        slice_ops = OZGEMM_OPS_PER_SLICE if k == 2 else 3 + add_ops(k)
        fold_ops = ADD_FLOAT_OPS if k == 2 else renorm_ops(k + 1, k)
        pre_ops = 2 * n * n * s_n * (slice_ops
                                     + (NARROW_NORM_OPS if narrow else 0))
        slabs = n * n * (n // plan.bk)
        f64_ops = (pre_ops
                   + slabs * (s_n * (fold_ops + (NARROW_RESCALE_OPS
                                                 if narrow else 0))
                              + (1 if narrow else 0))
                   + n * n * (2 * tier_mul_ops(k) + add_ops(k)))
        if sdt in ("float64", "float32") and adt == "float64":
            dot_ms = dots / DMMA_FMA_PER_S * 1e3  # f64 tensor cores
        else:  # bf16 or f16 (f32/f32's slices are f16-held) MMAs
            dot_ms = 2 * dots / BF16_TC_PEAK * 1e3
        if (sdt, adt) == ("bfloat16", "float64"):
            # a DADD per output for each f32 group a diagonal closes into
            # its f64 sum (none where one group holds the diagonal)
            cap = ozgemm.f32_group(plan.slice_beta)
            per_pair = ozslice.kdepth(plan.bk, 2) // 16
            f64_ops += slabs * sum(
                -(-r // cap) if r > cap else 0 for r in (
                    per_pair * len(range(max(0, d - s_n + 1), min(d + 1, s_n)))
                    for d in range(s_n)))
        b = bound(f64_ops, 8 * k * 4 * n * n + 8 * 2 * k)
        by = "operations" if dot_ms >= b[0] else b[1]
        return (max(b[0], dot_ms), by, dot_ms,
                f64_ops / F64_INSTR_PER_S * 1e3)

    def oz_record(name, source, replaces, n, k, plan, sdt, adt, times,
                  plain_ms, shape, context_ms, note, launches):
        one, pre, gemm = times
        b, by, dot_ms, f64_ms = oz_bound(n, k, plan, sdt, adt)
        ctx = "context_f64_matmul_ms" if sdt == "float64" \
            else "context_bf16_matmul_ms"
        record(name, source, replaces, one, plain_ms, (b, by), shape,
               context_ms, f"{note}; pre-pass {pre:.2f} ms + GEMM "
               f"{gemm:.2f} ms; bound parts: dots {dot_ms:.2f} ms, f64 "
               f"{f64_ms:.2f} ms", launches=launches,
               extra={ctx: context_ms, "bound_dots_ms": dot_ms,
                      "bound_f64_ms": f64_ms, "prepass_ms": pre,
                      "gemm_ms": gemm,
                      "slices": [plan.slice_beta, plan.n_slices]})

    def slice_record(p, n, plan, pre_ms):
        """The pre-pass's row: both operands' f64 slices at n^3."""
        k, s_n = NLIMBS[p], plan.n_slices
        a_s, b_s = (rand_tier((n, n), p) for _ in range(2))
        kw = dict(bk=plan.bk, beta=plan.slice_beta, n_slices=s_n)
        for x, rows in ((a_s, True), (b_s, False)):
            hold_ws(f"ozslice_{p}", f"{n}x{n} {'A' if rows else 'B'} f64",
                    ozslice.ozslice_call(mp.limbs(x), rows=rows, **kw),
                    ozslice.ozslice_plain(x, rows=rows, **kw))
        _, t = sync_time(lambda: (ozslice.ozslice_plain(a_s, rows=True, **kw),
                                  ozslice.ozslice_plain(b_s, rows=False,
                                                        **kw)))
        slice_ops = OZGEMM_OPS_PER_SLICE if k == 2 else 3 + add_ops(k)
        b = bound(2 * n * n * s_n * slice_ops,
                  2 * n * n * (8 * k + 8 * s_n))
        record(f"ozslice_{p}", sl_src, sl_rep, pre_ms, t * 1e3, b, [n, n],
               0.0, " (both operands, f64 slices)",
               launches=path1["ozslice"][k] + path2["ozslice"][k]
               + path10["ozslice"][k], extra={"slices": [plan.slice_beta,
                                                         s_n]})
        del a_s, b_s

    # the dd kernels at the first path's Rgemm shape, plain versions there
    n = 4096
    A, B, C = rand_dd(n, n), rand_dd(n, n), rand_dd(n, n)
    alpha, beta = scalar(1, 3), scalar(-1, 7)
    plan, pkw = oz_plan_kw(n, n, n, "dd")
    oz_ops, _ = oz_operands(A, B, "full", alpha, beta, C)
    ml_ms = event_ms(lambda: mlgemm.mlgemm_kernel_call(
        *mp.limbs(A), *mp.limbs(B)), 3)
    oz_t = oz_times(A, B, oz_ops, pkw, 3)
    want, t = sync_time(lambda: mlgemm.mlgemm_plain(A, B))
    ml_plain_ms = t * 1e3
    same, err = compare("mlgemm_dd", mlgemm.mlgemm_kernel_call(
        *mp.limbs(A), *mp.limbs(B)), want)
    log(f"phase 7: mlgemm_dd {n}^3 kernel == plain: {same} "
        f"(max abs diff {err:.3e})")
    check(same, f"mlgemm_dd {n}^3 differs from its plain version")
    want, t = sync_time(lambda: ozgemm.ozgemm_plain(
        A, B, bk=plan.bk, beta=plan.slice_beta,
        n_slices=plan.n_slices, alpha=alpha, beta_s=beta, c=C))
    oz_plain_ms = t * 1e3
    same, err = compare("ozgemm_dd", ozgemm.ozgemm_kernel_call(
        *oz_ops, epilogue="full", **pkw), want)
    log(f"phase 7: ozgemm_dd {n}^3 epilogue=full kernel == plain: {same} "
        f"(max abs diff {err:.3e})")
    check(same, f"ozgemm_dd {n}^3 differs from its plain version")
    del want
    f64_ms = event_ms(lambda: torch.matmul(A.hi, B.hi), 5)
    mnk = n ** 3
    record("mlgemm_dd", ml_src, ml_rep, ml_ms, ml_plain_ms,
           bound(mnk * MLGEMM_OPS_PER_FMA, 8 * 2 * 3 * n * n), [n, n, n],
           f64_ms)
    oz_record("ozgemm_dd", oz_src, oz_rep, n, 2, plan, "float64", "float64",
              oz_t, oz_plain_ms, [n, n, n], f64_ms, " (epilogue full)",
              path1["ozgemm"][2] + path2["ozgemm"][2])
    del A, B, C, oz_ops
    slice_record("dd", n, plan, oz_t[1])

    # the td/qd kernels at 2048^3, their plain versions at 256^3
    n, n_plain = 2048, 256
    for p in ("td", "qd"):
        k = NLIMBS[p]
        A, B, C = (rand_tier((n, n), p) for _ in range(3))
        alpha, beta = scalar(1, 3, p), scalar(-1, 7, p)
        plan, pkw = oz_plan_kw(n, n, n, p)
        oz_ops, _ = oz_operands(A, B, "full", alpha, beta, C)
        ml_ms = event_ms(lambda: mlgemm.mlgemm_kernel_call(
            *mp.limbs(A), *mp.limbs(B)), 2)
        oz_t = oz_times(A, B, oz_ops, pkw, 2)
        f64_ms = event_ms(lambda: torch.matmul(mp.limbs(A)[0],
                                               mp.limbs(B)[0]), 5)
        a_s, b_s, c_s = (rand_tier((n_plain, n_plain), p) for _ in range(3))
        _, t = sync_time(lambda: mlgemm.mlgemm_plain(a_s, b_s))
        ml_plain_ms = t * 1e3
        _, t = sync_time(lambda: ozgemm.ozgemm_plain(
            a_s, b_s, bk=plan.bk, beta=plan.slice_beta,
            n_slices=plan.n_slices, alpha=alpha, beta_s=beta, c=c_s))
        oz_plain_ms = t * 1e3
        mnk = n ** 3
        note = f" at {n_plain}^3"
        record(f"mlgemm_{p}", ml_src, ml_rep, ml_ms, ml_plain_ms,
               bound(mnk * fma_ops(k), 8 * k * 3 * n * n), [n, n, n],
               f64_ms, note)
        oz_record(f"ozgemm_{p}", oz_src, oz_rep, n, k, plan, "float64",
                  "float64", oz_t, oz_plain_ms, [n, n, n], f64_ms,
                  note + ", epilogue full",
                  path1["ozgemm"][k] + path2["ozgemm"][k])
        del A, B, C, oz_ops
        slice_record(p, n, plan, oz_t[1])

    # the narrow variants at the same shapes, epilogue full; their plain
    # versions at 512^3 (dd) and 256^3 (td/qd), held bit for bit again
    for p, n, n_plain in (("dd", 4096, 512), ("td", 2048, 256),
                          ("qd", 2048, 256)):
        k = NLIMBS[p]
        A, B, C = (rand_tier((n, n), p) for _ in range(3))
        alpha, beta = scalar(1, 3, p), scalar(-1, 7, p)
        a_s, b_s, c_s = (rand_tier((n_plain, n_plain), p) for _ in range(3))
        ops, _ = oz_operands(A, B, "full", alpha, beta, C)
        ops_s, kw_s = oz_operands(a_s, b_s, "full", alpha, beta, c_s)
        a16, b16 = mp.limbs(A)[0].bfloat16(), mp.limbs(B)[0].bfloat16()
        bf16_ms = event_ms(lambda: torch.matmul(a16, b16), 5)
        del a16, b16
        for sdt, adt in NARROW_PAIRS:
            name = narrow_name(p, sdt, adt)
            plan, pkw = oz_plan_kw(n, n, n, p, sdt, adt)
            times = oz_times(A, B, ops, pkw, 2)
            _, pkw_s = oz_plan_kw(n_plain, n_plain, n_plain, p, sdt, adt)
            want, t = sync_time(lambda: ozgemm.ozgemm_plain(
                a_s, b_s, **kw_s, **pkw_s))
            same, err = compare(name, ozgemm.ozgemm_kernel_call(
                *ops_s, epilogue="full", **pkw_s), want)
            log(f"phase 7: {name} {n_plain}^3 epilogue=full kernel == "
                f"plain: {same} (max abs diff {err:.3e})")
            check(same, f"{name} {n_plain}^3 differs from its plain version")
            oz_record(name, nz_src, nz_rep, n, k, plan, sdt, adt, times,
                      t * 1e3, [n, n, n], bf16_ms,
                      f" at {n_plain}^3, epilogue full",
                      path10["ozgemm"][
                          k, ozgemm.VARIANTS[ozgemm.SLICE_PAIRS[sdt, adt]]])
        del A, B, C, ops, ops_s
    # the bf16/f32 dd kernel on the SDP's Schur stack, where phase 10
    # launched it most: X @ (A_j Z^-1), 99 x 50x50x50 with X shared,
    # epilogue none; bound: the same count at this shape
    a, b = rand_tier((50, 50), "dd"), rand_tier((99, 50, 50), "dd")
    plan, pkw = oz_plan_kw(50, 50, 50, "dd", *NARROW_PAIRS[0])
    ms = event_ms(lambda: ozgemm.ozgemm_kernel_call(
        *mp.limbs(a), *mp.limbs(b), **pkw), 20)
    want, t = sync_time(lambda: ozgemm.ozgemm_plain(a, b, **pkw))
    name = narrow_name("dd", *NARROW_PAIRS[0])
    hold(name, "SDP stack 99 x 50x50x50 (A shared), timed", ozgemm.
         ozgemm_kernel_call(*mp.limbs(a), *mp.limbs(b), **pkw), want)
    s_n, entries = plan.n_slices, 99 * 50 * 50
    dot_ms = 2 * 50 * entries * pairs(s_n) / BF16_TC_PEAK * 1e3
    f64_ops = ((50 * 50 + entries) * s_n
               * (OZGEMM_OPS_PER_SLICE + NARROW_NORM_OPS)
               + entries * -(-50 // plan.bk) * (s_n * (ADD_FLOAT_OPS
                                                       + NARROW_RESCALE_OPS)
                                                + 1))
    b_ = bound(f64_ops, 8 * 2 * (50 * 50 + 2 * entries))
    stack_n = sum(cnt for (key, shp), cnt in stack_counts.items()
                  if key == (2, "bf16/f32") and shp == (99, 50, 50, 50))
    record(f"{name}_sdp_stack", nz_src, nz_rep, ms, t * 1e3,
           (max(b_[0], dot_ms), b_[1] if b_[0] >= dot_ms else "operations"),
           [99, 50, 50, 50], 0.0, " (A shared, epilogue none)",
           launches=stack_n,
           extra={"bound_dots_ms": dot_ms,
                  "bound_f64_ms": f64_ops / F64_INSTR_PER_S * 1e3,
                  "slices": [plan.slice_beta, s_n]})
    del a, b, want

    # the elementwise kernels on the SDP's pairwise product
    shape = [m_sdp, m_sdp, n_sdp, n_sdp]
    for p in ("dd", "td", "qd"):
        k = NLIMBS[p]
        st_a = rand_tier((m_sdp, 1, n_sdp, n_sdp), p)
        st_v = mp.map_limbs(lambda l: l.transpose(-1, -2),
                            rand_tier((1, m_sdp, n_sdp, n_sdp), p))
        ms = event_ms(lambda: mpops.mpops_call("mul", st_a, st_v), 3)
        _, t = sync_time(lambda: mpops.mpops_plain("mul", st_a, st_v))
        elems = m_sdp * m_sdp * n_sdp * n_sdp
        record(f"mpops_{p}", "src/repro_torch/csrc/mpops.cu",
               "src/repro/core/sdp.py:141", ms, t * 1e3,
               bound(elems * tier_mul_ops(k),
                     8 * k * (2 * m_sdp * n_sdp * n_sdp + elems)), shape,
               event_ms(lambda: torch.matmul(
                   mp.limbs(st_a)[0].reshape(m_sdp, -1),
                   mp.limbs(st_v)[0].reshape(m_sdp, -1).T), 5),
               " (mul of the pairwise_trace product; context: the f64 "
               "(m, n*n) x (n*n, m) matmul)")
        del st_a, st_v

    # ---- 11. the autotuner on the card, once ---------------------------
    n = 2048
    tuned, t = sync_time(lambda: autotune(n, n, n, backend="ozaki-pallas"))
    plan = make_plan(n, n, n, backend="ozaki-pallas")
    log(f"phase 11: autotune({n}, {n}, {n}, backend='ozaki-pallas') in "
        f"{t:.2f} s: bk={tuned.bk}, n_slices={tuned.n_slices}; cache "
        f"{default_cache().path}: "
        f"{json.dumps(json.loads(plans.read_text()))}; make_plan -> source="
        f"{plan.source}, bk={plan.bk}, n_slices={plan.n_slices}")
    check(plan.source == "tuned"
          and (plan.bk, plan.n_slices) == (tuned.bk, tuned.n_slices),
          "make_plan did not adopt the tuned entry")
    nplan = make_plan(n, n, n, backend="ozaki-pallas", **NARROW)
    want = slice_params(nplan.bk, "float32", "bfloat16", target_bits=107)
    log(f"phase 11: a bf16/f32 plan in the same bucket: source="
        f"{nplan.source}, bk={nplan.bk}, (beta, n_slices)="
        f"{(nplan.slice_beta, nplan.n_slices)}, re-solved {want}")
    check(nplan.source == "tuned" and nplan.bk == tuned.bk
          and (nplan.slice_beta, nplan.n_slices) == want
          and nplan.n_slices != tuned.n_slices,
          "a narrow plan adopted the tuned f64 slice count")
    shutil.rmtree(plans.parent, ignore_errors=True)

    log(f"phase 9 summary: {json.dumps(sdp_runs)}")
    log(f"phase 10 summary: {json.dumps(narrow_runs)}")
    log(f"every phase passed in {time.perf_counter() - t_start:.1f} s")
    log(smi)  # exactly as nvidia-smi prints name and power limit
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
