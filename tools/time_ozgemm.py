#!/usr/bin/env python3
"""Time kernel #2, the fused Ozaki-slice GEMM, on the card at the shapes of
PERF.md's kernel table, for whichever tree ``PYTHONPATH`` names.

    PYTHONPATH=<tree>/src python3 tools/time_ozgemm.py --label change

Rows, each one ``ozgemm_kernel_call`` (on a tree with the slicing
pre-pass: pre-pass and GEMM together, then each apart), CUDA events over
``--reps`` calls after one warm-up: every (slice, accumulator) pair the
tree's kernel takes (f64/f64, bf16/f32, f32/f32, f16/f32, bf16/f64,
f32/f64; ``--pairs f64,bf16/f64`` picks some) at dd 4096^3 and td/qd
2048^3, all with the epilogue full; and bf16/f32 at dd on the SDP's Schur
stack, 99 x 50x50x50 with A shared, epilogue none (its ``--reps`` times
20).  Operands are random tier values made on the card from a seed.

``--diagonals 0,1,2,4,8,15`` adds, on a tree with the pre-pass, each
chosen pair's dd GEMM alone (epilogue none) launched with only the first
d diagonals of every slab: what streaming the workspace, the pair dots
and the folds each cost.

Prints one JSON line: {"label", "card", "src", "rows": {row: ms}}.  To set
two trees side by side, unpack the other with ``git archive`` under
``build/`` and run both in one chip call, in the order A, B, B, A.
"""

import argparse
import json
import subprocess
import sys
import threading
import time

SHAPES = (("dd", 4096), ("td", 2048), ("qd", 2048))
PAIRS = {"f64": ("float64", "float64"), "bf16/f32": ("bfloat16", "float32"),
         "f32/f32": ("float32", "float32"), "f16/f32": ("float16", "float32"),
         "bf16/f64": ("bfloat16", "float64"),
         "f32/f64": ("float32", "float64")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--diagonals", default="")
    ap.add_argument("--pairs", default=",".join(PAIRS))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_ozgemm: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.core import mp
    from repro_torch.gemm import make_plan
    from repro_torch.kernels import _build, ozgemm

    pairs = [x for x in args.pairs.split(",")
             if PAIRS[x] in ozgemm.SLICE_PAIRS]  # what this tree takes
    # build what the rows launch, split sources apart (their variants)
    names = [n for n in _build.SOURCES if n in ("mpops", "ozslice", "ozgemm")]
    try:  # f16/f32 runs f32/f32's build (older trees have no map)
        from repro_torch.kernels.ozslice import CUDA_VARIANT
    except ImportError:
        CUDA_VARIANT = {}
    variants = sorted({CUDA_VARIANT.get(v, v) for v in (
        ozgemm.SLICE_PAIRS[PAIRS[x]] for x in pairs) if v is not None})
    t0 = time.perf_counter()
    jobs = [threading.Thread(target=_build.build_all, args=(names,))]
    jobs += [threading.Thread(target=_build.build_all, args=(
        ("ozgemm_narrow",),), kwargs={"variants": (v,)}) for v in variants]
    for j in jobs:
        j.start()
    for j in jobs:
        j.join()
    build_s = time.perf_counter() - t0

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20231017)

    def rand_tier(shape, p):
        x = mp.from_float(torch.randn(shape, generator=gen, device=dev,
                                      dtype=torch.float64), p)
        for i in range(1, mp.PRECISIONS[p]):
            x = mp.add(x, mp.from_float(torch.randn(
                shape, generator=gen, device=dev,
                dtype=torch.float64) * 2.0 ** (-53 * i), p))
        return x

    def scalar(num, p):
        return mp.from_float(torch.full((1, 1), num, dtype=torch.float64,
                                        device=dev), p)

    def event_ms(fn, reps):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def plan_kw(m, k, n, p, pair):
        sdt, adt = PAIRS[pair]
        plan = make_plan(m, k, n, precision=p, backend="ozaki-pallas",
                         platform="cuda", slice_dtype=sdt, acc_dtype=adt,
                         use_cache=False)
        return dict(bk=plan.bk, beta=plan.slice_beta, n_slices=plan.n_slices,
                    slice_dtype_name=sdt, acc_dtype_name=adt)

    prepass = None
    if "ozslice" in _build.SOURCES:
        from repro_torch.kernels import ozslice

        def prepass(a, b, ops, kw):
            """(pre-pass of both operands, the GEMM alone) in ms."""
            v = ozgemm.SLICE_PAIRS[kw["slice_dtype_name"],
                                   kw["acc_dtype_name"]]
            skw = dict(bk=kw["bk"], beta=kw["beta"],
                       n_slices=kw["n_slices"], variant=v)
            la, lb = list(mp.limbs(a)), list(mp.limbs(b))

            def both():
                return (ozslice.ozslice_call(la, rows=True, **skw),
                        ozslice.ozslice_call(lb, rows=False, **skw))

            pre = event_ms(both, args.reps)
            ws = both()
            _, _, _, alpha, beta, c = ozgemm._split_operands(ops, "full")
            gemm = event_ms(lambda: ozgemm._launch(
                len(la), la, lb, alpha, beta, c, None, bk=kw["bk"],
                beta=kw["beta"], n_slices=kw["n_slices"],
                n_diag=kw["n_slices"], epi="full", variant=v,
                workspaces=ws), args.reps)
            return pre, gemm

        def diagonals(a, b, kw):
            """The GEMM alone with the first d diagonals of each slab."""
            v = ozgemm.SLICE_PAIRS[kw["slice_dtype_name"],
                                   kw["acc_dtype_name"]]
            skw = dict(bk=kw["bk"], beta=kw["beta"],
                       n_slices=kw["n_slices"], variant=v)
            la, lb = list(mp.limbs(a)), list(mp.limbs(b))
            ws = (ozslice.ozslice_call(la, rows=True, **skw),
                  ozslice.ozslice_call(lb, rows=False, **skw))
            return {d: event_ms(lambda: ozgemm._launch(
                len(la), la, lb, None, None, None, None, n_diag=d,
                epi="none", workspaces=ws, **skw), args.reps)
                for d in map(int, args.diagonals.split(","))
                if d <= kw["n_slices"]}

    rows = {}
    for pair, (p, n) in ((x, y) for x in pairs for y in SHAPES):
        a, b, c = (rand_tier((n, n), p) for _ in range(3))
        ops = [*mp.limbs(a), *mp.limbs(b),
               *mp.limbs(scalar(1 / 3, p)), *mp.limbs(scalar(-1 / 7, p)),
               *mp.limbs(c)]
        kw = plan_kw(n, n, n, p, pair)
        rows[f"{pair} {p} {n}^3"] = event_ms(
            lambda: ozgemm.ozgemm_kernel_call(*ops, epilogue="full", **kw),
            args.reps)
        if prepass is not None:  # a tree with the pre-pass: the two apart
            rows[f"{pair} {p} {n}^3 pre-pass"], rows[
                f"{pair} {p} {n}^3 GEMM"] = prepass(a, b, ops, kw)
        if prepass is not None and args.diagonals and p == "dd":
            for d, ms in diagonals(a, b, kw).items():
                rows[f"{pair} {p} {n}^3 GEMM, {d} diagonals"] = ms
        del a, b, c, ops
    a, b = rand_tier((50, 50), "dd"), rand_tier((99, 50, 50), "dd")
    kw = plan_kw(50, 50, 50, "dd", "bf16/f32")
    rows["bf16/f32 dd SDP stack 99 x 50^3"] = event_ms(
        lambda: ozgemm.ozgemm_kernel_call(*mp.limbs(a), *mp.limbs(b), **kw),
        20 * args.reps)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"label": args.label, "card": card,
                      "src": repro_torch.__file__, "build_s": build_s,
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
