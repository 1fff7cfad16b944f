"""repro_torch — the PyTorch/CUDA port of ``repro``.

Multi-limb (dd, td, qd) GEMMs under MPLAPACK-style ``Rgemm``, batched or
not, the blocked LU they accelerate, the tiered refined solve above it and
the SDP interior-point method above that, on an NVIDIA H100.  The
reference's two Pallas kernels are hand-written CUDA C++ for sm_90a
(``csrc/``) at 2, 3 and 4 limbs, beside a third family for the elementwise
tier arithmetic, each with a plain PyTorch version.  This package imports
no JAX and nothing of ``repro``.  Entry points run on the card unless the
caller passes ``device="cpu"`` (or a CPU tensor).
"""

from . import core, gemm, kernels, solve  # noqa: F401
