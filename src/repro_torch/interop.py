"""Carrying state between the JAX reference and the port.

The system has no weights: its state is limb arrays and GEMM plans.  These
three functions move them across as numpy arrays and plain dicts, so a
test can run both packages on the same limbs and the same solved
``(bk, slice_beta, n_slices)``.  Nothing here imports the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._device import resolve_device
from .core import mp
from .gemm.plan import GemmPlan

__all__ = ["limbs_from_numpy", "limbs_to_numpy", "plan_from_dict"]

# reference plan fields with no counterpart here: the mesh object, and
# Pallas' interpret switch
_DROPPED = ("mesh", "interpret")


def limbs_from_numpy(limbs, precision: str, device=None):
    """A tier value from numpy limbs, most-significant first
    (``device=None`` -> CUDA)."""
    limbs = list(limbs)
    if len(limbs) != mp.PRECISIONS[precision]:
        raise ValueError(f"{precision} takes {mp.PRECISIONS[precision]} "
                         f"limbs, got {len(limbs)}")
    dev = resolve_device(device)
    return mp.from_limbs([torch.tensor(np.asarray(l, np.float64), device=dev)
                          for l in limbs])


def limbs_to_numpy(x) -> list:
    """The numpy limbs of a tier value, most-significant first."""
    return [l.detach().cpu().numpy() for l in mp.limbs(x)]


def plan_from_dict(d: dict) -> GemmPlan:
    """The port's GemmPlan from ``dataclasses.asdict(reference_plan)``.

    ``mesh`` and ``interpret`` are dropped; every other field keeps its
    name and value.  Unknown fields raise.
    """
    fields = {f.name for f in dataclasses.fields(GemmPlan)}
    kw = {k: v for k, v in d.items() if k not in _DROPPED}
    unknown = sorted(set(kw) - fields)
    if unknown:
        raise ValueError(f"fields {unknown} have no counterpart in the "
                         f"port's GemmPlan")
    if "batch_shape" in kw:
        kw["batch_shape"] = tuple(kw["batch_shape"])
    return GemmPlan(**kw)
