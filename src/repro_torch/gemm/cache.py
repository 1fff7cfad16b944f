"""On-disk plan cache: tuned block shapes keyed by (shape-bucket, dtype, platform).

The port of ``repro.gemm.cache``, whole: schema v4 keys, shape and batch
buckets, atomic writes, the corrupt-file warning with a retune, and the
quarantine records (storage only: nothing in the port writes them yet, and
``make_plan`` does not consult them; ROADMAP.md, queue item 4).  Key
strings equal the reference's for the same arguments, with platform
``cuda`` on the card.

The paper fixes one (M_Tile, PE-array) configuration at synthesis time;
the engine instead tunes block shapes at runtime and must not re-tune for
every call.  This cache is the synthesis artifact's software analogue: a
JSON file mapping schema-versioned ``vN/platform/dtype/bucket/backend``
keys to the winning ``(bm, bn, bk)`` — plus, for the slicing kernel, the
tuned ``n_slices`` — so `rgetrf`'s trailing updates, SDP's `rsyrk`-shaped
calls, and repeated service traffic all reuse one tuned tile per shape
bucket.

Shapes are bucketed to the next power of two per dimension, so a 500x500x500
and a 512x512x512 GEMM share a tuning entry — the same coarsening the paper
applies by synthesizing one design per M_Tile rather than per matrix size.

Location: ``$REPRO_TORCH_GEMM_CACHE`` if set, else
``~/.cache/repro_torch/gemm_plans.json``: apart from the reference's file,
so plans tuned on the card and plans tuned for the reference never share
one file.  Writes are atomic (tmp + rename) so concurrent tuners cannot
tear the file.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
import warnings
from typing import Optional

__all__ = ["PlanCache", "default_cache", "set_default_cache", "shape_bucket",
           "batch_bucket", "cache_key", "SCHEMA",
           "quarantine_key", "quarantine", "quarantined", "clear_quarantine",
           "QUARANTINE_TTL"]

_ENV_VAR = "REPRO_TORCH_GEMM_CACHE"

# how long a quarantined backend stays benched (seconds), as in the
# reference (the same REPRO_QUARANTINE_TTL override)
QUARANTINE_TTL = float(os.environ.get("REPRO_QUARANTINE_TTL", 86400.0))

# entry-schema version, embedded in every key.  v2: entries may carry an
# ``n_slices`` field (tuned alongside the blocks for the ozaki-pallas
# backend).  v3: keys fold in a batch bucket — a batched call runs
# ``prod(batch)`` kernel instances concurrently, so its on-chip pressure
# (and winning tile) differs from the 2-D bucket's by the batch factor; sharing
# one row silently reused 2-D tiles for batched work.  v4: the dtype
# segment always spells the limb count (``float64x2``, not bare
# ``float64`` for dd) — with the count-generic tier family the count is a
# first-class key axis, and the old dd-implicit spelling would collide
# with any future 2-limb format variant.  Bumping the version orphans old
# entries instead of letting them half-describe a plan: stale ``v3/...``
# rows are simply never consulted again (plans degrade to heuristics and
# re-tune), and stale quarantine rows are versioned separately below.
SCHEMA = 4


def _next_pow2(x: int, floor: int = 8) -> int:
    x = max(int(x), floor)
    return 1 << (x - 1).bit_length()


def shape_bucket(m: int, k: int, n: int) -> str:
    """Coarsen a problem shape to its power-of-two bucket."""
    return f"{_next_pow2(m)}x{_next_pow2(k)}x{_next_pow2(n)}"


def batch_bucket(batch_shape=()) -> str:
    """Coarsen a batch shape to its power-of-two size bucket.

    ``b1`` is the plain 2-D call; a batched call buckets on the flattened
    batch size (a (2, 3) batch and a (6,) batch load the card identically).
    """
    size = 1
    for d in batch_shape:
        size *= int(d)
    return f"b{_next_pow2(size, floor=1)}"


def cache_key(platform: str, dtype_name: str, m: int, k: int, n: int,
              backend: str, nlimbs: int = 2, batch_shape=()) -> str:
    """Cache key for one tuning bucket (schema-versioned).

    Keys on the limb count so precision tiers tune independently (a QD tile
    streams twice the limb planes of a DD tile and wants different blocks),
    on the batch bucket so batched plans tune apart from the 2-D bucket
    (their load differs by the batch factor), and on
    ``SCHEMA`` so entries written under an older entry layout are orphaned
    rather than misread.
    """
    dt = f"{dtype_name}x{nlimbs}"
    return (f"v{SCHEMA}/{platform}/{dt}/{batch_bucket(batch_shape)}/"
            f"{shape_bucket(m, k, n)}/{backend}")


class PlanCache:
    """JSON-backed block-shape cache with an in-memory write-through layer."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or os.environ.get(_ENV_VAR) or os.path.join(
            os.path.expanduser("~"), ".cache", "repro_torch",
            "gemm_plans.json")
        self._lock = threading.Lock()
        self._mem: Optional[dict] = None

    def _load(self) -> dict:
        if self._mem is None:
            try:
                with open(self.path) as f:
                    data = json.load(f)
            except OSError:
                data = {}  # no cache yet: the normal cold-start path
            except ValueError as e:
                # a corrupt/truncated file (killed writer, hand edit, disk
                # hiccup) must cost a warning and a retune, never an
                # exception in every GEMM that consults the cache
                warnings.warn(
                    f"ignoring corrupt GEMM plan cache {self.path!r} "
                    f"({e}); plans fall back to heuristics until re-tuned",
                    RuntimeWarning, stacklevel=3)
                data = {}
            if not isinstance(data, dict):
                warnings.warn(
                    f"GEMM plan cache {self.path!r} is not a JSON object "
                    f"(got {type(data).__name__}); ignoring it",
                    RuntimeWarning, stacklevel=3)
                data = {}
            self._mem = data
        return self._mem

    def get(self, key: str) -> Optional[dict]:
        with self._lock:
            entry = self._load().get(key)
        return dict(entry) if isinstance(entry, dict) else None

    def put(self, key: str, entry: dict) -> None:
        with self._lock:
            # re-read the file before writing so sequential tuners (and the
            # common run-then-run case) merge rather than clobber; the
            # rename below keeps the JSON untorn.  A true concurrent
            # interleaving can still lose the slower writer's entry — an
            # accepted cost for a tuning hint, which the loser re-derives.
            self._mem = None
            data = self._load()
            data[key] = dict(entry)
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._write_locked(data)

    def _write_locked(self, data: dict) -> None:
        """Atomically replace the cache file with ``data`` (lock held).

        Write-temp + ``os.replace`` in the destination directory, with an
        fsync before the rename: a writer killed at ANY point leaves
        either the old complete file or the new complete file — never a
        truncation — and a crash right after the rename cannot surface a
        zero-length file from an unflushed page cache.  The chaos suite's
        killed-writer injection asserts exactly this.
        """
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(self.path) or ".", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def drop_prefix(self, prefix: str) -> int:
        """Remove every entry whose key starts with ``prefix``; persist.

        The quarantine lifecycle's release valve: ``clear_quarantine``
        drops the ``quarantine/`` namespace without touching tuned blocks.
        Returns the number of entries dropped.
        """
        with self._lock:
            self._mem = None
            data = self._load()
            doomed = [k for k in data if k.startswith(prefix)]
            for k in doomed:
                del data[k]
            if doomed:
                os.makedirs(os.path.dirname(self.path) or ".",
                            exist_ok=True)
                self._write_locked(data)
            return len(doomed)

    def clear(self) -> None:
        with self._lock:
            self._mem = {}
            try:
                os.unlink(self.path)
            except OSError:
                pass


_default: Optional[PlanCache] = None
_default_explicit = False
_default_lock = threading.Lock()


def default_cache() -> PlanCache:
    global _default
    with _default_lock:
        if _default is None:
            _default = PlanCache()
        elif not _default_explicit:
            # re-resolve env-derived caches (both set AND unset transitions):
            # a cache installed via set_default_cache must win over
            # $REPRO_TORCH_GEMM_CACHE, but an env-derived one tracks the env var
            if _default.path != PlanCache().path:
                _default = PlanCache()
        return _default


def set_default_cache(cache: Optional[PlanCache]) -> None:
    """Override the process-wide cache (tests point this at tmp dirs)."""
    global _default, _default_explicit
    with _default_lock:
        _default = cache
        _default_explicit = cache is not None


# --------------------------------------------------------------------------
# backend quarantine: failed backends benched in the same cache file
# --------------------------------------------------------------------------
#
# In the reference, when a kernel backend fails at compile/run time the
# engine fails over down the plan's fallback chain, and re-attempting the
# doomed backend on every call would re-pay the failure.  The quarantine
# records "backend X is broken on platform P at N limbs" in the same JSON
# the tuner writes, so repeat calls (and fresh processes) skip the attempt
# at *plan* time (in the port: once failover is ported, ROADMAP.md queue
# item 4; the records are stored already).  Entries carry the failure
# reason and a timestamp; they expire after QUARANTINE_TTL so an upgraded
# toolchain heals without manual intervention.  Namespaced under ``quarantine/v1``
# so ``clear_quarantine`` can drop them without touching tuned blocks.

_QUAR_PREFIX = "quarantine/v1"


def quarantine_key(platform: str, backend: str, nlimbs: int = 2) -> str:
    """Quarantine entries key coarser than tuning entries: a backend that
    cannot lower for (platform, limb count) is broken for every shape."""
    return f"{_QUAR_PREFIX}/{platform}/{backend}/x{nlimbs}"


def quarantine(platform: str, backend: str, nlimbs: int = 2, *,
               reason: str = "", cache: Optional[PlanCache] = None) -> None:
    """Bench a backend for (platform, limb count) for QUARANTINE_TTL."""
    (cache or default_cache()).put(
        quarantine_key(platform, backend, nlimbs),
        {"reason": str(reason)[:500], "unix_time": time.time()})


def quarantined(platform: str, backend: str, nlimbs: int = 2, *,
                cache: Optional[PlanCache] = None) -> Optional[dict]:
    """The live quarantine entry for a backend, or None.

    Expired entries answer None (they are left on disk; the next
    ``quarantine``/``clear_quarantine`` write compacts them).
    """
    entry = (cache or default_cache()).get(
        quarantine_key(platform, backend, nlimbs))
    if not entry:
        return None
    try:
        age = time.time() - float(entry.get("unix_time", 0.0))
    except (TypeError, ValueError):
        return None  # malformed timestamp: treat as expired, not fatal
    if age > QUARANTINE_TTL:
        return None
    return entry


def clear_quarantine(cache: Optional[PlanCache] = None) -> int:
    """Lift every quarantine (``repro_torch.gemm.clear_quarantine()`` is the
    documented remedy once the environment is fixed).  Returns the count."""
    return (cache or default_cache()).drop_prefix(_QUAR_PREFIX)
