"""The blocked multi-limb matmul behind the ``xla`` backend.

The port of ``repro.kernels.ops.matmul_ml_xla``: the reference's
``lax.scan`` over K chunks becomes a Python loop.  Each chunk forms exact
(m, chunk, n) tier products, reduces them with the compensated halving
tree, and adds the partial into the accumulator, in the reference's order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import mp
from ..gemm.plan import round_up

__all__ = ["matmul_ml_xla"]


def matmul_ml_xla(a, b, *, chunk: int = 16):
    """C = A @ B at the operands' tier, K streamed in ``chunk``-deep steps
    (K zero-padded to a chunk multiple, as in the reference).  Leading
    batch dims broadcast (the reference vmaps this function)."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    batch = tuple(np.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
    kp = round_up(k, chunk)
    a = mp.map_limbs(lambda l: F.pad(l, (0, kp - k)), a)
    b = mp.map_limbs(lambda l: F.pad(l, (0, 0, 0, kp - k)), b)
    lead = mp.limbs(a)[0]
    acc = mp.zeros(batch + (m, n), mp.precision_of(a), dtype=lead.dtype,
                   device=lead.device)
    for k0 in range(0, kp, chunk):
        a_blk = mp.map_limbs(lambda l: l[..., :, k0:k0 + chunk, None], a)
        b_blk = mp.map_limbs(lambda l: l[..., None, k0:k0 + chunk, :], b)
        acc = mp.add(acc, mp.sum_(mp.mul(a_blk, b_blk), axis=-2))
    return acc

