"""Planning layer: one decision point for every extended-precision GEMM.

The port of ``repro.gemm.plan``.  ``GemmPlan`` is a frozen record of every
choice the engine needs — backend, block shapes, limb dtype, platform,
tier, and the solved Ozaki slice parameters — made once by ``make_plan``
from the problem shape, heuristics and caller overrides, then handed to
``engine.execute``.  The field names are the reference's, so a JAX plan
crosses over through ``repro_torch.interop.plan_from_dict``.

Backends keep their reference names.  On a CUDA tensor:

  * ``pallas``       -> kernel #1, the hand-written systolic-tile kernel
                        ``csrc/mlgemm.cu`` (``kernels/mlgemm.py``);
  * ``ozaki-pallas`` -> kernel #2, the fused Ozaki-slice kernel
                        ``csrc/ozgemm.cu`` (``kernels/ozgemm.py``), with the
                        alpha/beta epilogue fused into its drain;
  * ``ozaki``        -> whole-K slicing on f64 ``torch.matmul``
                        (``core/ozaki.py``), the default ``auto`` backend;
  * ``xla``          -> the K-chunked tier-arithmetic loop
                        (``kernels/ops.py``);
  * ``ref``          -> the O(m*k*n) oracle (``kernels/ref.py``).

On a CPU tensor each kernel wrapper runs its plain PyTorch version.
``batch_shape=`` plans a batched call (``batch="vmap"``, the reference's
name; the CUDA kernels take the batch as a grid axis).

Block shapes resolve as in the reference: explicit overrides > a tuned
entry of the port's plan cache (``gemm/cache.py``, written by
``gemm/autotune.py``) > the clamped heuristic ``DEFAULT_BLOCKS``.  Guarded
execution, SUMMA sharding and K streaming are not ported yet: their
options raise ``NotImplementedError`` naming the ROADMAP.md item that
brings them; so is the reference's quarantine consult, which needs the
engine's failover (ROADMAP.md queue item 4).
``interpret`` has no meaning without Pallas and is not a field here.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Optional, Tuple

import torch

from .._device import resolve_device
from ..core.mp import PRECISIONS
from . import cache as plan_cache

__all__ = ["GemmPlan", "make_plan", "resolve_backend", "round_up",
           "BACKENDS", "PRECISIONS", "DEFAULT_BLOCKS", "OZAKI_TARGET_BITS"]

BACKENDS = ("auto", "pallas", "ozaki", "ozaki-pallas", "xla", "ref")

PLATFORMS = ("cuda", "cpu")

# backends that decompose operands into error-free slices; their plans
# carry solved (slice_beta, n_slices) so kernels never re-derive them
_SLICED_BACKENDS = ("ozaki", "ozaki-pallas")

# default significand coverage per tier for the slicing backends
OZAKI_TARGET_BITS = {"dd": 107, "td": 159, "qd": 212}

# (bm, bn, bk) heuristic defaults, as in the reference.  The CUDA kernels
# tile the output themselves (kernel #1's bits depend on no block size,
# kernel #2's on bk only), so bk is the one field they read: kernel #1's
# K staging depth is its own, kernel #2's slab depth is the plan's bk.
DEFAULT_BLOCKS = {"bm": 128, "bn": 128, "bk": 16}

_ENV_BACKEND = "REPRO_GEMM_BACKEND"
_DEFAULT_BACKEND = "ozaki"


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """Everything ``engine.execute`` needs to run one GEMM workload."""

    backend: str                      # pallas | ozaki | ozaki-pallas | xla | ref
    bm: int                           # M-tile of the reference's Pallas grid
    bn: int                           # N-tile
    bk: int                           # K slab (ozaki-pallas) / xla K-chunk
    limb_dtype: str                   # 'float64' (dd64)
    platform: str                     # 'cuda' | 'cpu'
    precision: str = "dd"             # tier: dd (2 limbs) | td (3) | qd (4)
    batch: str = "none"               # none | vmap (a batch axis)
    batch_shape: Tuple[int, ...] = ()
    shard_axis: Optional[str] = None  # SUMMA sharding: not ported yet
    shard_axis_n: Optional[str] = None
    k_panel: Optional[int] = None
    comm: str = "ring"
    k_stream: Optional[int] = None    # out-of-core K streaming: not ported
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)
    slice_dtype: Optional[str] = None  # ozaki operand slices
    acc_dtype: Optional[str] = None    # ozaki accumulator
    n_slices: Optional[int] = None     # ozaki slices per operand (solved)
    slice_beta: Optional[int] = None   # ozaki bits per slice (solved)
    target_bits: Optional[int] = None  # ozaki significand coverage target
    full: Optional[bool] = None        # ozaki: keep sub-target slice products
    check: str = "none"                # guarded execution: not ported yet
    source: str = "heuristic"          # heuristic | tuned | override

    @property
    def blocks(self) -> dict:
        return {"bm": self.bm, "bn": self.bn, "bk": self.bk}

    @property
    def nlimbs(self) -> int:
        return PRECISIONS[self.precision]

    def with_(self, **changes) -> "GemmPlan":
        return dataclasses.replace(self, **changes)


def resolve_backend(backend: str = "auto") -> str:
    be = backend if backend != "auto" else os.environ.get(
        _ENV_BACKEND, _DEFAULT_BACKEND)
    if be not in BACKENDS or be == "auto":
        raise ValueError(f"unknown GEMM backend {be!r}; one of {BACKENDS}")
    return be


def resolve_platform(platform: Optional[str]) -> str:
    """``None`` -> ``cuda``, raising when CUDA is absent (no quiet CPU)."""
    if platform not in (None, *PLATFORMS):
        raise ValueError(f"unknown platform {platform!r}; one of "
                         f"{PLATFORMS}")
    return resolve_device(platform).type


def round_up(x: int, b: int) -> int:
    return -(-x // b) * b


def _clamp_blocks(m: int, k: int, n: int, blocks: dict) -> dict:
    # tiny problems keep tiny tiles: clamp to the 8-aligned problem size
    return {
        "bm": min(blocks["bm"], round_up(m, 8)),
        "bn": min(blocks["bn"], round_up(n, 8)),
        "bk": min(blocks["bk"], round_up(k, 8)),
    }


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, Open items: "
        f"{item!r})")


def make_plan(m: int, k: int, n: int, *, dtype=torch.float64,
              precision: str = "dd", backend: str = "auto",
              batch_shape: Tuple[int, ...] = (),
              bm: Optional[int] = None, bn: Optional[int] = None,
              bk: Optional[int] = None, platform: Optional[str] = None,
              mesh=None, shard_axis: Optional[str] = None,
              shard_axis_n: Optional[str] = None,
              k_panel: Optional[int] = None, comm: str = "ring",
              k_stream: Optional[int] = None,
              slice_dtype=None, acc_dtype=None,
              n_slices: Optional[int] = None,
              target_bits: Optional[int] = None, full: Optional[bool] = None,
              check: str = "none", use_cache: bool = True) -> GemmPlan:
    """Plan one GEMM workload (batch_shape) x (m, k) @ (k, n).

    Consults the tuned-block cache for (shape bucket, dtype, limb count,
    batch bucket, platform) before the clamped heuristic, as the reference
    does; ``use_cache=False`` skips it.  A tuned ``n_slices`` is adopted
    only when the caller gave no coverage target and no slice or
    accumulator dtype (it was tuned for the platform's dtypes at the
    default target).  ``platform=None`` means ``cuda`` (and raises
    without CUDA).
    """
    from ..core import ozaki as _ozaki

    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; "
                         f"one of {sorted(PRECISIONS)}")
    if mesh is not None or shard_axis is not None \
            or shard_axis_n is not None or k_panel is not None \
            or k_stream is not None or comm != "ring":
        _not_ported("SUMMA sharding and K streaming (mesh=, shard_axis=, "
                    "k_panel=, comm=, k_stream=)",
                    "SUMMA sharding + out-of-core K streaming")
    if check != "none":
        _not_ported(f"guarded execution (check={check!r})",
                    "Guarded execution and failure model")
    be = resolve_backend(backend)
    if precision == "qd" and be == "ozaki":
        if backend == "ozaki":
            raise ValueError(
                "backend 'ozaki' has no qd tier (slice count explodes past "
                "the 212-bit target); use ozaki-pallas, pallas, xla, or ref")
        be = "xla"  # 'auto'/env default 'ozaki' is a dd-oriented hint
    platform = resolve_platform(platform)
    dtype = _ozaki.as_dtype(dtype)

    source = "heuristic"
    blocks = dict(DEFAULT_BLOCKS)
    if use_cache and be in ("pallas", "xla", "ozaki-pallas") \
            and (bm, bn, bk) == (None,) * 3:
        key = plan_cache.cache_key(
            platform, str(dtype).removeprefix("torch."), m, k, n, be,
            nlimbs=PRECISIONS[precision], batch_shape=batch_shape)
        tuned = plan_cache.default_cache().get(key)
        # adopt only well-formed entries: a bad persistent value degrades
        # to the heuristic instead of breaking every GEMM in the bucket
        if tuned and all(isinstance(tuned.get(x), int) and tuned[x] > 0
                         for x in ("bm", "bn", "bk")):
            blocks = {x: int(tuned[x]) for x in ("bm", "bn", "bk")}
            source = "tuned"
            # a tuned n_slices covers the default target at the platform's
            # dtypes: a target or dtype override re-solves it (bf16 slices
            # cap beta at 8, so an f64-tuned count would under-cover)
            if be == "ozaki-pallas" and n_slices is None and \
                    target_bits is None and \
                    slice_dtype is None and acc_dtype is None and \
                    isinstance(tuned.get("n_slices"), int) and \
                    tuned["n_slices"] > 1:
                n_slices = tuned["n_slices"]
    blocks = _clamp_blocks(m, k, n, blocks)
    if bm or bn or bk:
        source = "override"
    blocks["bm"] = bm or blocks["bm"]
    blocks["bn"] = bn or blocks["bn"]
    blocks["bk"] = bk or blocks["bk"]

    slice_beta = None
    if be in _SLICED_BACKENDS:
        if slice_dtype is None and acc_dtype is None:
            slice_dtype, acc_dtype = _ozaki.platform_dtypes(platform)
        target_bits = target_bits or OZAKI_TARGET_BITS[precision]
        # the fused kernel slices per K-slab (depth bk), whole-K ozaki
        # slices the whole K — the exactness fixpoint sees that depth
        depth = blocks["bk"] if be == "ozaki-pallas" else k
        try:
            slice_beta, n_slices = _ozaki.slice_params(
                depth, acc_dtype or torch.float64, slice_dtype,
                target_bits=target_bits, n_slices=n_slices)
        except ValueError as e:
            # K too deep for exact slicing in the accumulator dtype: the
            # plan degrades to the portable 'xla' backend, as in the
            # reference, rather than crashing the caller
            warnings.warn(
                f"ozaki slicing infeasible for this problem ({e}); "
                f"falling back to the 'xla' backend", RuntimeWarning,
                stacklevel=2)
            be = "xla"
            slice_dtype = acc_dtype = None
            n_slices = target_bits = full = None

    def name(d):
        return str(_ozaki.as_dtype(d)).removeprefix("torch.") if d else None

    return GemmPlan(
        backend=be, limb_dtype=name(dtype), platform=platform,
        precision=precision, batch="vmap" if tuple(batch_shape) else "none",
        batch_shape=tuple(batch_shape), slice_dtype=name(slice_dtype),
        acc_dtype=name(acc_dtype), n_slices=n_slices,
        slice_beta=slice_beta, target_bits=target_bits, full=full,
        source=source, **blocks)
